from .header import Header, UNDEFINED
from .io import HDU, read_fits, write_fits, read_header, table_to_hdu

__all__ = ['Header', 'UNDEFINED', 'HDU', 'read_fits', 'write_fits',
           'read_header', 'table_to_hdu']
