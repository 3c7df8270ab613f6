"""JSON serialization for pipeline objects (twin of ``zuds_tpu/json_util.py``:
``record_from_image`` stores a header as this JSON, so the strings come out
equal in both packages)."""
from __future__ import annotations

import datetime
import json

import numpy as np

__all__ = ['to_json']


class PipelineEncoder(json.JSONEncoder):

    def default(self, o):
        if isinstance(o, (datetime.datetime, datetime.date)):
            return o.isoformat()
        if isinstance(o, bytes):
            return o.decode('utf-8', errors='replace')
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            v = float(o)
            return v if np.isfinite(v) else None
        if isinstance(o, np.bool_):
            return bool(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if hasattr(o, 'to_dict'):
            return o.to_dict()
        if hasattr(o, '__dataclass_fields__'):
            from dataclasses import asdict
            return asdict(o)
        return super().default(o)


def to_json(obj, **kwargs):
    return json.dumps(obj, cls=PipelineEncoder, **kwargs)
