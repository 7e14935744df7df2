"""Attribute-access dict used for configs and stats payloads.

Copy of `sample_factory_tpu/utils/attr_dict.py`; reference `sample_factory/utils/attr_dict.py` (AttrDict used throughout
the reference for cfg namespaces and message payloads).
"""

from __future__ import annotations


class AttrDict(dict):
    __setattr__ = dict.__setitem__

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        import copy

        return AttrDict({k: copy.deepcopy(v, memo) for k, v in self.items()})
