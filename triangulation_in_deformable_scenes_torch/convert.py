"""State carried across from the JAX package.

The system has no model weights; what the two packages share is the problem
and its state. These helpers take the fields of the JAX package's
``PairData``/``PairState``/``Hyper`` (``models/deformable.py:129-184``) as
numpy arrays (a NamedTuple, its ``_asdict()`` or any mapping) and return the
port's tuples on ``device``, so both packages compute from identical inputs.
Index fields become int64, masks bool, everything else f32; a leading pair
axis (the stacked batch that ``solve_pairs`` takes) carries over as it is.
``ba_data_from_numpy``/``ba_state_from_numpy`` do the same for bundle
adjustment's ``BAData``/``BAState`` (``models/bundle_adjustment.py:38-53``).
``keypoints_from_numpy`` does the same for the front end's ``Keypoints``
(``ops/features.py:244-251``): octaves int32, descriptors uint8 0/1 bits.
``halo_plan_from_numpy`` takes the JAX package's ``HaloPlan``
(``parallel/halo.py:85-103``), host numpy there and here, field by field.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.bundle_adjustment import BAData, BAState
from .models.deformable import Hyper, PairData, PairState
from .ops.features import Keypoints
from .parallel.halo import HaloPlan
from .precision import FP

_INDEX_FIELDS = {"nbr", "obs_kf", "obs_mp"}
_BOOL_FIELDS = {"valid", "nbr_mask", "obs_valid", "fixed_pose"}


def _fields(src) -> dict:
    if hasattr(src, "_asdict"):
        return dict(src._asdict())
    return dict(src)


def _tensor(name, value, device):
    arr = np.asarray(value)
    if name in _INDEX_FIELDS:
        return torch.as_tensor(arr.astype(np.int64), device=device)
    if name in _BOOL_FIELDS:
        return torch.as_tensor(arr.astype(bool), device=device)
    return torch.as_tensor(arr.astype(np.float32), dtype=FP, device=device)


def _convert(cls, src, device):
    f = _fields(src)
    missing = [k for k in cls._fields if k not in f and k not in cls._field_defaults]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    return cls(**{k: _tensor(k, v, device) for k, v in f.items() if k in cls._fields})


def pair_data_from_numpy(src, device="cuda") -> PairData:
    return _convert(PairData, src, torch.device(device))


def pair_state_from_numpy(src, device="cuda") -> PairState:
    return _convert(PairState, src, torch.device(device))


def hyper_from_numpy(src, device="cuda") -> Hyper:
    return _convert(Hyper, src, torch.device(device))


def ba_data_from_numpy(src, device="cuda") -> BAData:
    return _convert(BAData, src, torch.device(device))


def ba_state_from_numpy(src, device="cuda") -> BAState:
    return _convert(BAState, src, torch.device(device))


def keypoints_from_numpy(src, device="cuda") -> Keypoints:
    """The JAX package's ``Keypoints`` (as numpy arrays, a NamedTuple or a
    mapping) as the port's, on ``device``."""
    f = _fields(src)
    dev = torch.device(device)
    dtypes = {"octave": torch.int32, "desc": torch.uint8, "valid": torch.bool}
    return Keypoints(**{
        k: torch.as_tensor(np.array(f[k]), device=dev).to(dtypes.get(k, FP)) for k in Keypoints._fields
    })


def halo_plan_from_numpy(src) -> HaloPlan:
    """The JAX package's ``HaloPlan`` (a NamedTuple or a mapping) as the
    port's: every array as numpy with its dtype, the counts as ints."""
    f = _fields(src)
    return HaloPlan(**{k: (int(f[k]) if k in ("n_shards", "n_boundary") else np.asarray(f[k]))
                       for k in HaloPlan._fields})
