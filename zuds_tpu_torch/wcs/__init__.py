from .tpv import TPVWCS, MappingGrid, pixel_mapping, tpv_terms

__all__ = ['TPVWCS', 'MappingGrid', 'pixel_mapping', 'tpv_terms']
