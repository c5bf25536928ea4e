"""Feature binning: raw values → small-integer bins.

Role parity with the reference BinMapper (include/LightGBM/bin.h:61-209,
src/io/bin.cpp): greedy equal-frequency bin boundaries (GreedyFindBin,
bin.cpp:74-148), a dedicated zero bin (FindBinWithZeroAsOneBin,
bin.cpp:150-207), missing-value modes None/Zero/NaN (FindBin,
bin.cpp:208-300), and count-sorted categorical bins (bin.cpp:303-360).

Host-side (numpy): binning is a one-time ingest step; the result is a packed
integer matrix shipped to TPU HBM.  The algorithms are re-implemented from the
observed semantics, vectorized where possible.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.log import Log

K_ZERO_THRESHOLD = 1e-35

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

BIN_TYPE_NUMERICAL = 0
BIN_TYPE_CATEGORICAL = 1


def _double_up(v: float) -> float:
    """Next representable double — boundaries are exclusive upper bounds that
    must still satisfy `value <= bound` for the boundary value itself."""
    return float(np.nextafter(v, np.inf))


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Equal-frequency boundaries over (distinct value, count) pairs.

    Heavily-repeated values (count >= mean bin size) are pinned to their own
    bin; remaining budget is re-spread over the rest (bin.cpp:74-148).
    """
    n = len(distinct_values)
    bounds: List[float] = []
    if n == 0:
        return [np.inf]
    if n <= max_bin:
        cur = 0
        for i in range(n - 1):
            cur += int(counts[i])
            if cur >= min_data_in_bin:
                val = _double_up((distinct_values[i] + distinct_values[i + 1]) / 2.0)
                if not bounds or val > bounds[-1]:
                    bounds.append(val)
                    cur = 0
        bounds.append(np.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    is_big = counts >= mean_bin_size
    rest_bin_cnt = max_bin - int(is_big.sum())
    rest_sample_cnt = total_cnt - int(counts[is_big].sum())
    mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)

    uppers: List[float] = []
    lowers: List[float] = [float(distinct_values[0])]
    cur = 0
    for i in range(n - 1):
        if not is_big[i]:
            rest_sample_cnt -= int(counts[i])
        cur += int(counts[i])
        if is_big[i] or cur >= mean_bin_size or \
                (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5)):
            uppers.append(float(distinct_values[i]))
            lowers.append(float(distinct_values[i + 1]))
            if len(uppers) >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin_cnt -= 1
                mean_bin_size = rest_sample_cnt / max(rest_bin_cnt, 1)
    for i in range(len(uppers)):
        val = _double_up((uppers[i] + lowers[i + 1]) / 2.0)
        if not bounds or val > bounds[-1]:
            bounds.append(val)
    bounds.append(np.inf)
    return bounds


def find_bin_with_zero_as_one_bin(distinct_values: np.ndarray, counts: np.ndarray,
                                  max_bin: int, total_cnt: int,
                                  min_data_in_bin: int) -> List[float]:
    """Split the value range at zero so bin(0.0) is exact (bin.cpp:150-207)."""
    left_mask = distinct_values <= -K_ZERO_THRESHOLD
    right_mask = distinct_values > K_ZERO_THRESHOLD
    zero_mask = ~left_mask & ~right_mask
    left_cnt_data = int(counts[left_mask].sum())
    cnt_zero = int(counts[zero_mask].sum())
    right_cnt_data = int(counts[right_mask].sum())

    left_cnt = int(left_mask.sum())
    bounds: List[float] = []
    if left_cnt > 0:
        denom = max(total_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt_data / denom * (max_bin - 1)))
        bounds = greedy_find_bin(distinct_values[:left_cnt], counts[:left_cnt],
                                 left_max_bin, left_cnt_data, min_data_in_bin)
        bounds[-1] = -K_ZERO_THRESHOLD
    if right_cnt_data > 0 or right_mask.any():
        right_start = np.argmax(right_mask) if right_mask.any() else -1
    else:
        right_start = -1
    if right_start >= 0:
        right_max_bin = max_bin - 1 - len(bounds)
        right_bounds = greedy_find_bin(distinct_values[right_start:], counts[right_start:],
                                       right_max_bin, right_cnt_data, min_data_in_bin)
        bounds.append(K_ZERO_THRESHOLD)
        bounds.extend(right_bounds)
    else:
        bounds.append(np.inf)
    return bounds


class BinMapper:
    """Per-feature raw-value ↔ bin mapping."""

    def __init__(self):
        self.num_bin = 1
        self.missing_type = MISSING_NONE
        self.is_trivial = True
        self.sparse_rate = 0.0
        self.bin_type = BIN_TYPE_NUMERICAL
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        self.bin_2_categorical: List[int] = []
        self.categorical_2_bin: dict = {}
        self.min_val = 0.0
        self.max_val = 0.0
        self.default_bin = 0  # bin of raw value 0.0

    # -- construction (bin.cpp FindBin:208-360) ------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int = 3, min_split_data: int = 0,
                 bin_type: int = BIN_TYPE_NUMERICAL, use_missing: bool = True,
                 zero_as_missing: bool = False) -> None:
        values = np.asarray(values, dtype=np.float64)
        na_mask = np.isnan(values)
        non_na = values[~na_mask]
        na_cnt = int(na_mask.sum())
        if not use_missing:
            self.missing_type = MISSING_NONE
        elif zero_as_missing:
            self.missing_type = MISSING_ZERO
        else:
            self.missing_type = MISSING_NAN if na_cnt > 0 else MISSING_NONE

        # implicit zeros: rows not present in the sample (sparse ingest)
        zero_cnt = int(total_sample_cnt - len(non_na) - na_cnt)
        distinct, counts = self._distinct_with_zero(non_na, zero_cnt)
        if len(distinct) == 0:
            distinct = np.array([0.0])
            counts = np.array([max(zero_cnt, 1)])
        self.min_val, self.max_val = float(distinct[0]), float(distinct[-1])
        self.bin_type = bin_type

        if bin_type == BIN_TYPE_NUMERICAL:
            if self.missing_type == MISSING_ZERO:
                bounds = find_bin_with_zero_as_one_bin(distinct, counts, max_bin,
                                                       total_sample_cnt, min_data_in_bin)
                if len(bounds) == 2:
                    self.missing_type = MISSING_NONE
            elif self.missing_type == MISSING_NONE:
                bounds = find_bin_with_zero_as_one_bin(distinct, counts, max_bin,
                                                       total_sample_cnt, min_data_in_bin)
            else:  # NaN: reserve the last bin for NaN
                bounds = find_bin_with_zero_as_one_bin(distinct, counts, max_bin - 1,
                                                       total_sample_cnt - na_cnt,
                                                       min_data_in_bin)
                bounds.append(np.nan)
            self.bin_upper_bound = np.array(bounds)
            self.num_bin = len(bounds)
            self.default_bin = self.value_to_bin(0.0)
        else:
            self._find_bin_categorical(distinct, counts, max_bin, total_sample_cnt,
                                       na_cnt, min_data_in_bin)

        self.is_trivial = self.num_bin <= 1
        counts_per_bin = self._cnt_in_bin(distinct, counts, na_cnt)
        if self.num_bin > 0 and len(counts_per_bin):
            self.sparse_rate = float(counts_per_bin[self.default_bin]) / max(total_sample_cnt, 1)

    @staticmethod
    def _distinct_with_zero(non_na: np.ndarray, zero_cnt: int) -> Tuple[np.ndarray, np.ndarray]:
        """Distinct sorted values with the implicit-zero count merged in."""
        if len(non_na) == 0:
            if zero_cnt > 0:
                return np.array([0.0]), np.array([zero_cnt])
            return np.array([]), np.array([], dtype=np.int64)
        vals = np.sort(non_na)
        distinct, counts = np.unique(vals, return_counts=True)
        if zero_cnt > 0:
            zero_pos = np.searchsorted(distinct, 0.0)
            if zero_pos < len(distinct) and distinct[zero_pos] == 0.0:
                counts = counts.copy()
                counts[zero_pos] += zero_cnt
            else:
                distinct = np.insert(distinct, zero_pos, 0.0)
                counts = np.insert(counts, zero_pos, zero_cnt)
        return distinct, counts

    def _find_bin_categorical(self, distinct: np.ndarray, counts: np.ndarray,
                              max_bin: int, total_cnt: int, na_cnt: int,
                              min_data_in_bin: int = 3) -> None:
        """Count-sorted categorical bins (bin.cpp:303-371): most frequent
        category ↔ bin 0 (but never category 0, which stays off bin 0 for the
        sparse default), rare tail / negatives / NaN fold to the LAST bin,
        which split finding excludes unless missing_type is None."""
        ints = distinct.astype(np.int64)
        neg = ints < 0
        if neg.any():
            Log.warning("Met negative value in categorical features, will convert it to NaN")
            na_cnt += int(np.asarray(counts)[neg].sum())
        ints, counts = ints[~neg], np.asarray(counts)[~neg]
        agg: dict = {}
        for v, c in zip(ints, counts):
            agg[int(v)] = agg.get(int(v), 0) + int(c)
        vals = sorted(agg, key=lambda v: -agg[v])
        cnts = [agg[v] for v in vals]
        rest_cnt = total_cnt - na_cnt
        self.num_bin = 0
        self.bin_2_categorical = []
        self.categorical_2_bin = {}
        if rest_cnt > 0 and vals:
            # avoid first bin being category zero (bin.cpp:325-333)
            if vals[0] == 0:
                if len(vals) == 1:
                    vals.append(1)
                    cnts.append(0)
                vals[0], vals[1] = vals[1], vals[0]
                cnts[0], cnts[1] = cnts[1], cnts[0]
            cut_cnt = int(rest_cnt * 0.99)
            max_bin_eff = min(len(vals), max_bin)
            used = 0
            cur = 0
            while cur < len(vals) and (used < cut_cnt or self.num_bin < max_bin_eff):
                if cnts[cur] < min_data_in_bin and cur > 1:
                    break
                self.bin_2_categorical.append(vals[cur])
                self.categorical_2_bin[vals[cur]] = self.num_bin
                used += cnts[cur]
                self.num_bin += 1
                cur += 1
            if cur == len(vals) and na_cnt > 0:
                # dedicated NaN bin, category -1 (bin.cpp:354-360)
                self.bin_2_categorical.append(-1)
                self.categorical_2_bin[-1] = self.num_bin
                self.num_bin += 1
            if cur == len(vals) and na_cnt == 0:
                self.missing_type = MISSING_NONE
            elif na_cnt == 0:
                self.missing_type = MISSING_ZERO
            else:
                self.missing_type = MISSING_NAN
        # ValueToBin(0): category 0's bin, or the overflow (last) bin
        self.default_bin = self.categorical_2_bin.get(0, max(self.num_bin - 1, 0))

    def _cnt_in_bin(self, distinct: np.ndarray, counts: np.ndarray, na_cnt: int) -> np.ndarray:
        out = np.zeros(max(self.num_bin, 1), dtype=np.int64)
        if self.bin_type == BIN_TYPE_NUMERICAL:
            if len(distinct):
                idx = np.searchsorted(self.bin_upper_bound[:-1], distinct, side="left")
                np.add.at(out, np.minimum(idx, self.num_bin - 1), counts)
            if self.missing_type == MISSING_NAN and self.num_bin >= 1:
                out[self.num_bin - 1] = na_cnt
        else:
            for v, c in zip(distinct.astype(np.int64), counts):
                b = self.categorical_2_bin.get(int(v))
                if b is not None:
                    out[b] += int(c)
        return out

    # -- mapping (bin.h ValueToBin:452-488) ----------------------------------
    def value_to_bin(self, value) -> int:
        return int(self.values_to_bins(np.array([value]))[0])

    def values_to_bins(self, values: np.ndarray) -> np.ndarray:
        """Vectorized raw value → bin index."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            # negative / unseen -> last bin; NaN -> last bin when
            # missing_type is NaN, else treated as category 0
            # (bin.h ValueToBin:452-487)
            last = max(self.num_bin - 1, 0)
            out = np.full(len(values), last, dtype=np.int32)
            for i, v in enumerate(values):
                if np.isnan(v):
                    if self.missing_type != MISSING_NAN:
                        out[i] = self.categorical_2_bin.get(0, last)
                elif int(v) >= 0:
                    out[i] = self.categorical_2_bin.get(int(v), last)
            return out
        nan_mask = np.isnan(values)
        if self.missing_type == MISSING_NAN:
            # non-NaN values bin over bounds[:-2] (last numeric bin), NaN → last bin
            search_bounds = self.bin_upper_bound[:-2] if self.num_bin >= 2 else self.bin_upper_bound[:0]
            vals = np.where(nan_mask, 0.0, values)
            idx = np.searchsorted(search_bounds, vals, side="left")
            idx = np.where(nan_mask, self.num_bin - 1, idx)
        else:
            vals = np.where(nan_mask, 0.0, values)  # NaN treated as zero
            idx = np.searchsorted(self.bin_upper_bound[:-1], vals, side="left")
        return idx.astype(np.int32)

    def bin_to_value(self, bin_idx: int) -> float:
        """Representative threshold for saving models (upper bound of the bin)."""
        if self.bin_type == BIN_TYPE_CATEGORICAL:
            return float(self.bin_2_categorical[bin_idx])
        return float(self.bin_upper_bound[bin_idx])

    def feature_info(self) -> str:
        """Model-file feature_infos entry: `[min:max]` or category list."""
        if self.is_trivial:
            return "none"
        if self.bin_type == BIN_TYPE_NUMERICAL:
            return "[%s:%s]" % (repr(self.min_val), repr(self.max_val))
        # bin order, not sorted (bin.h bin_info:176-185)
        return ":".join(str(c) for c in self.bin_2_categorical)

    # -- serialization for distributed find-bin ------------------------------
    def to_arrays(self):
        return {
            "num_bin": self.num_bin, "missing_type": self.missing_type,
            "is_trivial": self.is_trivial, "sparse_rate": self.sparse_rate,
            "bin_type": self.bin_type,
            "bin_upper_bound": np.asarray(self.bin_upper_bound, dtype=np.float64),
            "bin_2_categorical": np.asarray(self.bin_2_categorical, dtype=np.int64),
            "min_val": self.min_val, "max_val": self.max_val,
            "default_bin": self.default_bin,
        }

    @classmethod
    def from_arrays(cls, d) -> "BinMapper":
        m = cls()
        m.num_bin = int(d["num_bin"]); m.missing_type = int(d["missing_type"])
        m.is_trivial = bool(d["is_trivial"]); m.sparse_rate = float(d["sparse_rate"])
        m.bin_type = int(d["bin_type"])
        m.bin_upper_bound = np.asarray(d["bin_upper_bound"])
        m.bin_2_categorical = [int(v) for v in d["bin_2_categorical"]]
        m.categorical_2_bin = {v: i for i, v in enumerate(m.bin_2_categorical)}
        m.min_val = float(d["min_val"]); m.max_val = float(d["max_val"])
        m.default_bin = int(d["default_bin"])
        return m
