"""4-bit bin storage (counterpart of lightgbm_tpu/io/nbits.py;
dense_nbits_bin.hpp:37 role).

The reference keeps <=16-bin features nibble-packed in RAM because its
histogram kernel reads the bin array directly.  Here the training working
set is the f32 payload matrix, so packing pays off at the storage
boundary instead: the binary dataset cache is halved for <=16-bin
datasets.  Host RAM and the upload keep the unpacked matrix.

Layout: storage column pairs (2k, 2k+1) share one uint8 row; column 2k in
the high nibble.  An odd trailing column packs alone, in the high nibble.
The layout is the JAX package's, so a cache packed by either package
unpacks in the other.
"""
from __future__ import annotations

import numpy as np


def packable(group_num_bins) -> bool:
    """True when every storage column fits in a nibble and packing saves."""
    arr = np.asarray(group_num_bins)
    return arr.size >= 2 and bool((arr <= 16).all())


def should_pack(ds) -> bool:
    """Whether the binary cache stores the dataset's bins packed."""
    return ds.bins.dtype == np.uint8 and packable(ds.storage_num_bins())


def pack_nibbles(bins: np.ndarray) -> np.ndarray:
    """[G, N] uint8 (values < 16) -> [ceil(G/2), N] uint8."""
    if bins.dtype != np.uint8 or bins.max(initial=0) >= 16:
        raise ValueError("pack_nibbles takes uint8 bins below 16")
    G, N = bins.shape
    out = np.zeros(((G + 1) // 2, N), np.uint8)
    out[: G // 2] = (bins[0::2][: G // 2] << 4) | bins[1::2]
    if G % 2:
        out[-1] = bins[-1] << 4
    return out


def unpack_nibbles(packed: np.ndarray, num_columns: int) -> np.ndarray:
    """Inverse of pack_nibbles."""
    out = np.empty((num_columns, packed.shape[1]), np.uint8)
    out[0::2] = packed[: (num_columns + 1) // 2] >> 4
    out[1::2] = packed[: num_columns // 2] & 0x0F
    return out

