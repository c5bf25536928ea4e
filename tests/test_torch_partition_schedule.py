"""The in-place schedule of the card's whole partitions, emulated on the CPU.

On the card, B2 (lightgbm_tpu_torch/csrc/segment_partition.cu), B3 and B8
(csrc/segment_partition_wide.cu) compact the larger side of a split in
place in the payload and send the smaller side through aux; tiles take
tickets in walk order (forward when the left side is in place, backward
when the right side is), publish a "read" flag once their rows are staged,
and write in place only after the flags of the tiles their in-place rows
land on.  B2 and B3 stage whole rows in tiles of T rows, B3 at its own
geometry (rows of 2-6.5 KB, so a few rows per tile); B8 stages tiles of
rows by column blocks, each column block with its own flags.  All keep
two staging buffers, publishing a block's next tile after its current
tile's writes, and claim a ticket one tile ahead.  B6
(csrc/segment_partition_hist.cu) runs B2's schedule and then, in the
launch that copies the smaller side back, both children's histograms
from the rows where the move left them: the larger side in the payload,
the smaller side in aux.  A CUDA kernel cannot run here, so this file
emulates that schedule in plain Python, with the kernels' own wait sets
and destinations, on resident blocks stepped by an adversarial scheduler
(every tile reads as late and writes as early as its flags allow) or at
random, and holds the payload and num_left against the JAX package's
plain partition (lightgbm_tpu.ops.segment.partition_segment), and B6's
histograms against the JAX package's histogram of each child
(lightgbm_tpu.ops.segment.segment_histogram).  B2's stage
(csrc/segment_partition.cu's part_stage_move) runs the same ticketed
tiles out of place: both sides of every tile go to aux at their final
rows, with no flag and no wait; it is held against the JAX package's
stage (aux over the segment and num_left), and the commit's copy-back
after it against the JAX package's commit.  A variant that writes
before the flags must corrupt the payload, so the check is seen to have
teeth.
"""
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from lightgbm_tpu.ops import segment as jseg
from lightgbm_tpu_torch.ops import segment as tseg

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

F, B = 5, 16
P = F + 4
VALUE_COL = F + 3
#: B6's histogram columns; its count mask is made 0 / 1 for its cases
GRAD_COL, HESS_COL, CNT_COL = F, F + 1, F + 2
N_PAD = 256
LEFT_VALUE, RIGHT_VALUE = -0.25, 0.75
AUX_FILL = -7.5

# the seven routing cases of chip_smoke.py's predicates()
PREDICATES = {
    "numerical": dict(feature=1, threshold=B // 2),
    "nan_missing_default_left": dict(feature=2, threshold=5, missing_type=2,
                                     default_left=True),
    "zero_missing": dict(feature=3, threshold=6, missing_type=1,
                         default_bin=4, default_left=True),
    "categorical": dict(feature=0, is_cat=True,
                        bitset=np.arange(B) % 3 == 0),
    "efb_offset": dict(feature=4, threshold=3, offset=5, identity=False,
                       num_bin=9),
    "all_left": dict(feature=1, threshold=B),
    "all_right": dict(feature=1, threshold=-1),
}

_JAX_PARTITION = jax.jit(jseg.partition_segment, static_argnums=(7,))
_JAX_STAGE = jax.jit(jseg.partition_segment_stage)
_JAX_COMMIT = jax.jit(jseg.partition_segment_commit, static_argnums=(7,))

_CSRC = Path(__file__).resolve().parent.parent / "lightgbm_tpu_torch" / "csrc"


def _b3_tile_rows(width: int) -> int:
    """B3's rows per tile at payload width `width`: move_tile_rows of
    csrc/segment_partition_inplace.cuh at B3's staging bytes
    (kRmwStageBytes of csrc/segment_partition_wide.cu)."""
    text = (_CSRC / "segment_partition_wide.cu").read_text()
    stage = int(re.search(r"kRmwStageBytes = (\d+) \* 1024;",
                          text).group(1)) * 1024
    t = stage // (4 * width)
    if t == 0:
        return 1
    return t - t % 32 if t >= 32 else t


#: B3's tile rows at the payload widths it serves (513 <= P < 1665)
B3_TILE_ROWS = sorted({_b3_tile_rows(w) for w in (513, 978, 1664)})


def _payload(seed=0):
    rng = np.random.default_rng(seed)
    pay = np.zeros((N_PAD + jseg.GUARD, P), np.float32)
    pay[:N_PAD, :F] = rng.integers(0, B, size=(N_PAD, F))
    pay[:N_PAD, F:] = rng.standard_normal((N_PAD, P - F))
    return pay


def _pred_fields(feature=1, threshold=B // 2, default_left=False,
                 is_cat=False, bitset=None, missing_type=0, num_bin=B,
                 default_bin=0, offset=0, identity=True):
    return dict(col=np.int32(feature), threshold=np.int32(threshold),
                default_left=np.bool_(default_left), is_cat=np.bool_(is_cat),
                bitset=np.asarray(bitset if bitset is not None
                                  else np.zeros(B, bool)),
                missing_type=np.int32(missing_type),
                num_bin=np.int32(num_bin), default_bin=np.int32(default_bin),
                offset=np.int32(offset), identity=np.bool_(identity))


def _reference(pay, start, count, name):
    """The JAX package's plain partition: (payload, num_left)."""
    fields = _pred_fields(**PREDICATES[name])
    pred = jseg.SplitPredicate(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    out, _, nl = _JAX_PARTITION(
        jnp.asarray(pay), jnp.zeros(pay.shape, jnp.float32),
        jnp.int32(start), jnp.int32(count), pred, jnp.float32(LEFT_VALUE),
        jnp.float32(RIGHT_VALUE), VALUE_COL)
    return np.asarray(out), int(nl)


def _routing(pay, start, count, name):
    """Each segment row's side, as the kernels' predicate gives it (the
    port's plain go_left)."""
    fields = _pred_fields(**PREDICATES[name])
    pred = tseg.SplitPredicate(**{k: torch.as_tensor(v)
                                  for k, v in fields.items()})
    rows = torch.from_numpy(pay[start:start + count])
    return tseg.go_left_chunk(rows, pred).numpy().astype(bool)


class Deadlock(AssertionError):
    pass


class Schedule:
    """One whole partition of payload rows [start, start + count) on
    `blocks` resident blocks.  kernel "b2", "b3" or "b6": tiles of
    tile_rows whole rows, each side of a tile written as one span from the
    tile's left offset (move_tiles, which B2's part_move, B3's rmw_move
    and B6's phist_move run); kernel "stage": the same tiles out of place
    (move_tiles<true>, B2's part_stage_move: both spans into aux, no leaf
    value, no wait, no copy-back); kernel "b8": tiles of tile_rows rows by
    column blocks of col_block floats, each row to the destination the
    routing ranked (block_move).  honour_flags=False writes without
    waiting."""

    def __init__(self, pay, start, count, gl, kernel, tile_rows, col_block,
                 blocks, honour_flags=True):
        self.pay = pay.copy()
        self.aux = np.full_like(pay, AUX_FILL)
        self.s, self.c, self.gl = start, count, gl
        self.kernel, self.T, self.blocks = kernel, tile_rows, blocks
        self.honour = honour_flags
        self.nl = int(gl.sum())
        # left_in_place: the larger side (the left on a tie) stays
        self.fwd = self.nl >= count - self.nl
        self.ntiles = -(-count // tile_rows)
        self.stage = kernel == "stage"
        self.whole_rows = kernel in ("b2", "b3", "b6", "stage")
        self.cb = P if self.whole_rows else col_block
        self.ncb = -(-P // self.cb)
        self.nticket = self.ntiles * self.ncb
        # the count and scan launches: each tile's left rows and offset
        self.tile_left = [int(gl[t * tile_rows:(t + 1) * tile_rows].sum())
                          for t in range(self.ntiles)]
        self.tile_off = np.concatenate(
            [[0], np.cumsum(self.tile_left)[:-1]]).astype(int) \
            if self.ntiles else np.zeros(0, int)
        # route_rank: each row's destination row
        lb = np.cumsum(gl) - gl
        r = np.arange(count)
        self.dest = np.where(gl, start + lb, start + self.nl + (r - lb))
        self.flags = np.zeros((self.ntiles, self.ncb), bool)
        self.ticket = 0

    # -- one tile ---------------------------------------------------------

    def _job(self, tk):
        i, cb = divmod(tk, self.ncb)
        t = i if self.fwd else self.ntiles - 1 - i
        r0 = t * self.T
        return t, cb, r0, min(self.T, self.c - r0), cb * self.cb, \
            min(self.cb, P - cb * self.cb)

    def _claim(self):
        tk = self.ticket
        self.ticket += 1
        return tk

    def _read(self, tk):
        t, cb, r0, nr, c0, cw = self._job(tk)
        rows = self.pay[self.s + r0:self.s + r0 + nr, c0:c0 + cw].copy()
        self.flags[t, cb] = True
        return rows

    def _waits(self, tk):
        """The (tile, column block) flags the kernel waits for before its
        in-place writes."""
        t, cb, r0, nr, _, _ = self._job(tk)
        if self.stage:
            return []
        if self.whole_rows:
            lt, off = self.tile_left[t], int(self.tile_off[t])
            in0 = off if self.fwd else self.nl + r0 - off
            n_in = lt if self.fwd else nr - lt
            if n_in == 0:
                return []
            return [(j, cb) for j in range(in0 // self.T,
                                           (in0 + n_in - 1) // self.T + 1)]
        in_place = [rr for rr in range(nr) if self.gl[r0 + rr] == self.fwd]
        if not in_place:
            return []
        first = int(self.dest[r0 + in_place[0]]) - self.s
        last = int(self.dest[r0 + in_place[-1]]) - self.s
        return [(j, cb) for j in range(first // self.T,
                                       last // self.T + 1)]

    def _write(self, tk, rows):
        t, cb, r0, nr, c0, cw = self._job(tk)
        vals = rows.copy()
        if c0 <= VALUE_COL < c0 + cw and not self.stage:
            vals[:, VALUE_COL - c0] = np.where(self.gl[r0:r0 + nr],
                                               LEFT_VALUE, RIGHT_VALUE)
        if self.whole_rows:
            # the tile's lefts as one span from its left offset, its
            # rights as one span after the earlier tiles' rights
            off = int(self.tile_off[t])
            side = self.gl[r0:r0 + nr]
            spans = ((side, self.s + off, self.fwd),
                     (~side, self.s + self.nl + r0 - off, not self.fwd))
            for mask, first, in_place in spans:
                dst = self.pay if in_place and not self.stage else self.aux
                m = int(mask.sum())
                dst[first:first + m, c0:c0 + cw] = vals[mask]
            return
        for rr in range(nr):
            in_place = bool(self.gl[r0 + rr]) == self.fwd
            dst = self.pay if in_place else self.aux
            dst[int(self.dest[r0 + rr]), c0:c0 + cw] = vals[rr]

    # -- a block's program and the scheduler ------------------------------

    def _block(self):
        """A persistent block with two staging buffers, as the kernels run
        it: it claims the ticket after its next tile while it works on the
        current one.  Yields its next step before taking it: ("claim",),
        ("read",) or ("write", flags it waits for)."""
        yield ("claim",)
        tk = self._claim()
        if tk >= self.nticket:
            return
        yield ("read",)
        rows = self._read(tk)
        yield ("claim",)
        nk = self._claim()
        while True:
            yield ("claim",)
            after = self._claim()
            yield ("write", self._waits(tk))
            self._write(tk, rows)
            if nk >= self.nticket:
                return
            # the next tile's copies land no later than its flag
            yield ("read",)
            rows = self._read(nk)
            tk, nk = nk, after

    def _ready(self, step):
        if step[0] != "write" or not self.honour:
            return True
        return all(self.flags[j] for j in step[1])

    def run(self, policy, seed):
        """Steps the blocks until all are done; then, for B6, both
        children's histograms (self.hists) from the rows where the move
        left them, and the smaller side's copy-back.  "adversarial": a
        ready write first, then a claim, a read last; "random": any ready
        step.  Returns (payload, aux, num_left)."""
        rng = random.Random(seed)
        rank = {"write": 0, "claim": 1, "read": 2}
        live = {}
        for b in range(self.blocks):
            gen = self._block()
            live[b] = (gen, next(gen))
        while live:
            ready = [b for b, (_, step) in live.items() if self._ready(step)]
            if not ready:
                raise Deadlock("no block can step: %s"
                               % {b: s for b, (_, s) in live.items()})
            if policy == "adversarial":
                best = min(rank[live[b][1][0]] for b in ready)
                ready = [b for b in ready if rank[live[b][1][0]] == best]
            b = rng.choice(ready)
            gen = live[b][0]
            try:
                live[b] = (gen, next(gen))
            except StopIteration:
                del live[b]
        if self.stage:
            return self.pay, self.aux, self.nl
        lo, hi = (self.s + self.nl, self.s + self.c) if self.fwd \
            else (self.s, self.s + self.nl)
        if self.kernel == "b6":
            rows = np.where(((np.arange(self.pay.shape[0]) >= lo)
                             & (np.arange(self.pay.shape[0]) < hi))[:, None],
                            self.aux, self.pay)
            self.hists = [_row_order_hist(rows, self.s, self.nl),
                          _row_order_hist(rows, self.s + self.nl,
                                          self.c - self.nl)]
        # the smaller side's one contiguous range, aux -> payload
        self.pay[lo:hi] = self.aux[lo:hi]
        return self.pay, self.aux, self.nl


def _row_order_hist(rows, start, count):
    """[F, B, 3] f32 sums of (grad, hess, count mask) over rows
    [start, start + count), added in row order."""
    out = np.zeros((F, B, 3), np.float32)
    seg_rows = rows[start:start + count]
    for j in range(F):
        b = seg_rows[:, j].astype(np.int64)
        for ch, col in enumerate((GRAD_COL, HESS_COL, CNT_COL)):
            np.add.at(out[j, :, ch], b, seg_rows[:, col])
    return out


def _jax_hist(pay, start, count):
    return np.asarray(jseg.segment_histogram(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count),
        num_features=F, num_bins=B, grad_col=GRAD_COL, hess_col=HESS_COL,
        cnt_col=CNT_COL))


def _check_stage(pay, start, count, name, tile_rows, blocks, policy, seed):
    """The stage against the JAX package's stage, then the commit's
    copy-back (aux -> payload, leaf values in VALUE_COL) against the JAX
    package's commit."""
    gl = _routing(pay, start, count, name)
    got_pay, got_aux, got_nl = Schedule(pay, start, count, gl, "stage",
                                        tile_rows, P, blocks).run(policy,
                                                                  seed)
    fields = _pred_fields(**PREDICATES[name])
    pred = jseg.SplitPredicate(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    ref_aux, ref_nl = _JAX_STAGE(
        jnp.asarray(pay), jnp.zeros(pay.shape, jnp.float32),
        jnp.int32(start), jnp.int32(count), pred)
    assert got_nl == int(ref_nl)
    np.testing.assert_array_equal(got_pay.view(np.int32), pay.view(np.int32))
    seg_rows = slice(start, start + count)
    np.testing.assert_array_equal(
        got_aux[seg_rows].view(np.int32),
        np.asarray(ref_aux)[seg_rows].view(np.int32))
    outside = np.ones(pay.shape[0], bool)
    outside[seg_rows] = False
    assert (got_aux[outside] == AUX_FILL).all()
    # the commit: the segment's rows back, left rows' value first
    committed = got_pay.copy()
    committed[seg_rows] = got_aux[seg_rows]
    committed[start:start + got_nl, VALUE_COL] = LEFT_VALUE
    committed[start + got_nl:start + count, VALUE_COL] = RIGHT_VALUE
    ref_pay = _JAX_COMMIT(
        jnp.asarray(pay), ref_aux, jnp.int32(start), jnp.int32(count),
        ref_nl, jnp.float32(LEFT_VALUE), jnp.float32(RIGHT_VALUE), VALUE_COL)
    np.testing.assert_array_equal(committed.view(np.int32),
                                  np.asarray(ref_pay).view(np.int32))


def _check(pay, start, count, name, kernel, tile_rows, col_block, blocks,
           policy, seed):
    if kernel == "stage":
        return _check_stage(pay, start, count, name, tile_rows, blocks,
                            policy, seed)
    if kernel == "b6":
        pay = pay.copy()
        pay[:, CNT_COL] = (pay[:, CNT_COL] > 0).astype(np.float32)
    gl = _routing(pay, start, count, name)
    sched = Schedule(pay, start, count, gl, kernel, tile_rows, col_block,
                     blocks)
    got_pay, got_aux, got_nl = sched.run(policy, seed)
    ref_pay, ref_nl = _reference(pay, start, count, name)
    assert got_nl == ref_nl
    np.testing.assert_array_equal(got_pay.view(np.int32),
                                  ref_pay.view(np.int32))
    if kernel == "b6":
        for got, (s, c) in zip(sched.hists, ((start, ref_nl),
                                             (start + ref_nl,
                                              count - ref_nl))):
            ref = _jax_hist(ref_pay, s, c)
            np.testing.assert_array_equal(got[..., 2], ref[..., 2])
            np.testing.assert_allclose(got[..., :2], ref[..., :2],
                                       rtol=1e-5, atol=1e-5)
    # aux is scratch over the segment and untouched outside it
    outside = np.ones(pay.shape[0], bool)
    outside[start:start + count] = False
    assert (got_aux[outside] == AUX_FILL).all()


SEGMENTS = st.integers(0, N_PAD).flatmap(
    lambda s: st.tuples(st.just(s), st.sampled_from(
        sorted({0, 1, min(3, N_PAD - s), N_PAD - s})) | st.integers(
            0, N_PAD - s)))


@settings(max_examples=150, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(segment=SEGMENTS, name=st.sampled_from(sorted(PREDICATES)),
       tile_rows=st.sampled_from([1, 2, 3, 5, 8, 32, 64]),
       blocks=st.sampled_from([1, 2, 3, 7]),
       policy=st.sampled_from(["adversarial", "random"]),
       seed=st.integers(0, 2 ** 16))
def test_b2_schedule_matches_jax(segment, name, tile_rows, blocks, policy,
                                 seed):
    start, count = segment
    _check(_payload(seed % 3), start, count, name, "b2", tile_rows, P,
           blocks, policy, seed)


@settings(max_examples=150, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(segment=SEGMENTS, name=st.sampled_from(sorted(PREDICATES)),
       tile_rows=st.sampled_from([1] + B3_TILE_ROWS),
       blocks=st.sampled_from([1, 2, 3, 7, 16]),
       policy=st.sampled_from(["adversarial", "random"]),
       seed=st.integers(0, 2 ** 16))
def test_b3_schedule_matches_jax(segment, name, tile_rows, blocks, policy,
                                 seed):
    """B3's whole-row tiles at its own geometry: the rows per tile it takes
    at P = 513, 978 and 1664 (and one row), on up to 16 resident
    blocks."""
    start, count = segment
    _check(_payload(seed % 3), start, count, name, "b3", tile_rows, P,
           blocks, policy, seed)


@settings(max_examples=150, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(segment=SEGMENTS, name=st.sampled_from(sorted(PREDICATES)),
       tile_rows=st.sampled_from([1, 2, 3, 8, 16]),
       col_block=st.sampled_from([1, 2, 3, 4, 5, 9, 16]),
       blocks=st.sampled_from([1, 2, 3, 7]),
       policy=st.sampled_from(["adversarial", "random"]),
       seed=st.integers(0, 2 ** 16))
def test_b8_schedule_matches_jax(segment, name, tile_rows, col_block, blocks,
                                 policy, seed):
    start, count = segment
    _check(_payload(seed % 3), start, count, name, "b8", tile_rows,
           col_block, blocks, policy, seed)


@settings(max_examples=60, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(segment=SEGMENTS, name=st.sampled_from(sorted(PREDICATES)),
       tile_rows=st.sampled_from([1, 2, 3, 5, 8, 32, 64]),
       blocks=st.sampled_from([1, 2, 3, 7]),
       policy=st.sampled_from(["adversarial", "random"]),
       seed=st.integers(0, 2 ** 16))
def test_b6_schedule_matches_jax(segment, name, tile_rows, blocks, policy,
                                 seed):
    """B6: B2's schedule, then both children's histograms read where the
    move left the rows."""
    start, count = segment
    _check(_payload(seed % 3), start, count, name, "b6", tile_rows, P,
           blocks, policy, seed)


@settings(max_examples=150, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(segment=SEGMENTS, name=st.sampled_from(sorted(PREDICATES)),
       tile_rows=st.sampled_from([1, 2, 3, 5, 8, 32, 64]),
       blocks=st.sampled_from([1, 2, 3, 7]),
       policy=st.sampled_from(["adversarial", "random"]),
       seed=st.integers(0, 2 ** 16))
def test_stage_schedule_matches_jax(segment, name, tile_rows, blocks, policy,
                                    seed):
    """B2's stage: the whole partition's tiles by ticket, out of place."""
    start, count = segment
    _check(_payload(seed % 3), start, count, name, "stage", tile_rows, P,
           blocks, policy, seed)


#: each kernel's rows per tile in the fixed cases: 8 for B2, B6, B8 and
#: the stage, B3's at the Bosch width (P = 978)
KERNEL_TILE_ROWS = {"b2": 8, "b3": _b3_tile_rows(978), "b6": 8, "b8": 8,
                    "stage": 8}


@pytest.mark.parametrize("kernel", ["b2", "b3", "b6", "b8", "stage"])
@pytest.mark.parametrize("name", sorted(PREDICATES))
def test_every_predicate_both_walks(kernel, name):
    """Every predicate kind on an unaligned mid segment; all_left and
    all_right take the forward and the backward walk."""
    for policy in ("adversarial", "random"):
        _check(_payload(1), 13, 211, name, kernel, KERNEL_TILE_ROWS[kernel],
               4, 5, policy, 7)


@pytest.mark.parametrize("kernel", ["b2", "b3", "b6", "b8", "stage"])
@pytest.mark.parametrize("start,count", [(0, N_PAD), (17, 0), (40, 1),
                                         (3, 97)])
def test_edge_segments(kernel, start, count):
    _check(_payload(2), start, count, "numerical", kernel,
           KERNEL_TILE_ROWS[kernel], 4, 3, "adversarial", 1)


@pytest.mark.parametrize("kernel", ["b2", "b3", "b6", "b8"])
def test_walk_direction_follows_the_larger_side(kernel):
    pay = _payload(0)
    for name, fwd in (("all_left", True), ("all_right", False)):
        gl = _routing(pay, 0, 100, name)
        assert Schedule(pay, 0, 100, gl, kernel, KERNEL_TILE_ROWS[kernel],
                        4, 2).fwd is fwd


@pytest.mark.parametrize("kernel", ["b2", "b3", "b6", "b8"])
@pytest.mark.parametrize("name", ["numerical", "zero_missing"])
def test_writes_before_the_flags_corrupt_the_payload(kernel, name):
    """Without the waits, the adversarial schedule writes in place over
    rows their tiles have not read yet: the emulation has teeth."""
    pay = _payload(0)
    gl = _routing(pay, 0, N_PAD, name)
    ref_pay, _ = _reference(pay, 0, N_PAD, name)
    T = KERNEL_TILE_ROWS[kernel]
    got_pay, _, _ = Schedule(pay, 0, N_PAD, gl, kernel, T, 4, 4,
                             honour_flags=False).run("adversarial", 0)
    assert not np.array_equal(got_pay.view(np.int32), ref_pay.view(np.int32))
    # with the waits, the same schedule is right
    got_pay, _, _ = Schedule(pay, 0, N_PAD, gl, kernel, T, 4, 4).run(
        "adversarial", 0)
    np.testing.assert_array_equal(got_pay.view(np.int32),
                                  ref_pay.view(np.int32))
