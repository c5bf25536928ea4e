"""Atomic model publish / subscribe (counterpart of
lightgbm_tpu/runtime/publish.py; the serving layer's contract).

The continuous trainer (runtime/continuous.py) hands freshly trained
models to consumers (the serving runtime, a file watcher) so that a
consumer never observes a torn, partial or checksum-invalid model,
whenever the publisher dies.  The seam is a directory of immutable
generation files plus a manifest pointer, in the JAX package's formats
byte for byte, so a generation that one package publishes resolves in
the other:

* ``gen_<N>.txt``: the full model text followed by two footer lines past
  ``end of trees``: ``!publish_meta=`` (base64 of zlib of JSON: the
  generation, the wall clock, the training provenance) and
  ``!publish_checksum=sha256:`` over everything above it, written
  atomically (tmp + fsync + rename).
* ``MANIFEST.json``: an atomic pointer to the newest generation with its
  sha256.  It is a cache: a subscriber that finds it stale, torn or
  missing falls back to a directory scan, so a publisher dying between
  the generation's rename and the manifest write
  (`LGBM_TPU_FAULT=die_at_publish`) costs freshness, never correctness.
* ``ROLLBACK.json`` (generations a canary condemned, and the ones the
  fleet is pinned to), ``rejected_<N>.txt`` (the gate's rejections, with
  the same footer) and ``warmup.json`` (the shape manifest of
  runtime/warmup.py), each its own atomic file that pruning never
  touches.

Retention is keep-last-K plus a grace window: a generation beyond the K
newest is unlinked only once it is also older than `grace_s`, and
`ModelSubscriber.resolve` validates the bytes it read in the same pass,
so a lost race shows as "skip and fall back", never as a corrupt model.

No torch or numpy at module scope: a subscriber never touches the card.
"""
from __future__ import annotations

import base64
import contextlib
import hashlib
import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from . import resilience, tracing

__all__ = ["ModelPublisher", "ModelSubscriber", "PublishedModel",
           "NoValidGeneration", "generation_paths", "validate_generation",
           "read_rollback_marker", "mark_rollback", "rejection_paths",
           "WARMUP_MANIFEST"]

_META_PREFIX = "!publish_meta="
_CHECKSUM_PREFIX = "!publish_checksum=sha256:"
_GEN_PREFIX = "gen_"
_GEN_SUFFIX = ".txt"
_REJECT_PREFIX = "rejected_"
MANIFEST = "MANIFEST.json"
#: durable quality-rollback marker.  A single
#: atomic JSON file in the publish dir naming the generations the canary
#: condemned — it is not a gen_ file, so pruning never touches it, a
#: relaunched subscriber reads it before its first resolve, and
#: concurrent readers all see one consistent bad-set.
ROLLBACK_MARKER = "ROLLBACK.json"
#: checksummed shape manifest published alongside the generations
#: (runtime/warmup.py): what shape buckets and program sites this
#: lineage's producers/consumers actually compiled.  Like the rollback
#: marker it is its own atomic non-generation file — pruning never
#: touches it and concurrent readers can never observe it torn.
WARMUP_MANIFEST = "warmup.json"


class NoValidGeneration(RuntimeError):
    """No valid published generation could be resolved (after retries)."""


def _gen_name(generation: int) -> str:
    return "%s%08d%s" % (_GEN_PREFIX, generation, _GEN_SUFFIX)


def generation_paths(pub_dir: str) -> List[Tuple[int, str]]:
    """Existing generation files, newest first (by generation number —
    publication order, not mtime, which a relaunch's republish rewrites)."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(pub_dir)
    except OSError:
        return []
    for name in names:
        if name.startswith(_GEN_PREFIX) and name.endswith(_GEN_SUFFIX):
            digits = name[len(_GEN_PREFIX):-len(_GEN_SUFFIX)]
            if digits.isdigit():
                out.append((int(digits), os.path.join(pub_dir, name)))
    out.sort(reverse=True)
    return out


def read_rollback_marker(pub_dir: str) -> Dict[str, Any]:
    """The durable rollback record: ``{"bad_generations": [...],
    "pinned": [...], "events": [...]}`` (empty dict when no rollback has
    ever happened).  A torn/unreadable marker reads as empty — the
    marker is written atomically, so that only happens when it does not
    exist."""
    try:
        with open(os.path.join(pub_dir, ROLLBACK_MARKER)) as fh:
            rec = json.load(fh)
        if isinstance(rec, dict):
            return rec
    except (OSError, ValueError):
        pass
    return {}


def mark_rollback(pub_dir: str, bad_generation: int,
                  pinned_generation: Optional[int] = None,
                  reason: str = "", evidence: Optional[Dict] = None
                  ) -> Dict[str, Any]:
    """Condemn `bad_generation` fleet-wide: merge it into the publish
    dir's ROLLBACK marker (read-merge-atomic-write, so concurrent
    replicas condemning independently both land) and record the
    generation the fleet is rolled back to.  Every subscriber —
    including ones launched AFTER this call — skips condemned
    generations during resolution; the marker survives pruning and
    relaunch because it is its own atomic non-generation file."""
    rec = read_rollback_marker(pub_dir)
    bad = set(int(g) for g in rec.get("bad_generations", []))
    bad.add(int(bad_generation))
    pinned = set(int(g) for g in rec.get("pinned", []))
    if pinned_generation is not None:
        pinned.add(int(pinned_generation))
    events = list(rec.get("events", []))
    events.append({"bad_generation": int(bad_generation),
                   "pinned_generation": pinned_generation,
                   "reason": reason, "evidence": evidence,
                   "wallclock": resilience.wallclock()})
    out = {"bad_generations": sorted(bad), "pinned": sorted(pinned),
           "events": events[-64:]}
    resilience.atomic_write(os.path.join(pub_dir, ROLLBACK_MARKER),
                            json.dumps(out, indent=1))
    return out


def rejection_paths(pub_dir: str) -> List[Tuple[int, str]]:
    """Persisted gate rejections (``rejected_<N>.txt``), newest first."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(pub_dir)
    except OSError:
        return []
    for name in names:
        if name.startswith(_REJECT_PREFIX) and name.endswith(_GEN_SUFFIX):
            digits = name[len(_REJECT_PREFIX):-len(_GEN_SUFFIX)]
            if digits.isdigit():
                out.append((int(digits), os.path.join(pub_dir, name)))
    out.sort(reverse=True)
    return out


def _with_publish_footer(model_text: str, meta: Dict[str, Any]) -> str:
    body = model_text
    if not body.endswith("\n"):
        body += "\n"
    blob = base64.b64encode(zlib.compress(json.dumps(meta).encode())).decode()
    body += _META_PREFIX + blob + "\n"
    digest = hashlib.sha256(body.encode()).hexdigest()
    return body + _CHECKSUM_PREFIX + digest + "\n"


def _split_validate(text: str) -> Optional[Tuple[str, Dict[str, Any]]]:
    """(model_text, meta) from a generation file's full text, or None if
    the file is torn/corrupt/not-a-publication.  Validation runs on the
    bytes ALREADY READ — there is no second open, so a file pruned or
    rewritten mid-observation can only ever look invalid, never torn."""
    if not text.endswith("\n"):
        return None                      # a complete publish ends in \n
    lines = text.rstrip("\n").split("\n")
    if len(lines) < 2 or not lines[-1].startswith(_CHECKSUM_PREFIX):
        return None
    digest = lines[-1][len(_CHECKSUM_PREFIX):].strip()
    body = text[: text.rfind(_CHECKSUM_PREFIX)]
    if hashlib.sha256(body.encode()).hexdigest() != digest:
        return None
    if not lines[-2].startswith(_META_PREFIX):
        return None
    try:
        meta = json.loads(zlib.decompress(
            base64.b64decode(lines[-2][len(_META_PREFIX):])).decode())
    except (ValueError, zlib.error):
        return None
    model_text = text[: text.rfind(_META_PREFIX)]
    return model_text, meta


def validate_generation(path: str) -> Tuple[bool, str]:
    """(ok, reason) for a generation file on disk."""
    try:
        with open(path, "rb") as fh:
            text = fh.read().decode("utf-8", "replace")
    except OSError as e:
        return False, "unreadable: %s" % e
    if _split_validate(text) is None:
        return False, "torn or checksum-invalid"
    return True, "ok"


class PublishedModel:
    """One resolved generation: the validated bytes travel WITH the
    resolution (no re-open between validate and use)."""

    __slots__ = ("generation", "path", "model_text", "meta")

    def __init__(self, generation: int, path: str, model_text: str,
                 meta: Dict[str, Any]):
        self.generation = generation
        self.path = path
        self.model_text = model_text
        self.meta = meta


class ModelPublisher:
    """Single-writer publication endpoint for one model lineage.

    ``publish(model_text, meta)`` assigns the next generation number
    (resuming past whatever a dead predecessor left on disk), writes the
    generation file atomically, updates the manifest, and prunes old
    generations under the keep-last-K + grace-window rule.
    """

    def __init__(self, pub_dir: str, keep_last: int = 8,
                 grace_s: float = 30.0):
        self.pub_dir = pub_dir
        self.keep_last = int(keep_last)
        self.grace_s = float(grace_s)
        os.makedirs(pub_dir, exist_ok=True)
        self._publish_count = 0          # this process, 1-based after ++

    # -- state on disk -------------------------------------------------------
    def latest_valid(self) -> Optional[PublishedModel]:
        """Newest VALID generation by directory scan (the truth a
        relaunch reconciles against; the manifest may be stale)."""
        for gen, path in generation_paths(self.pub_dir):
            try:
                with open(path, "rb") as fh:
                    text = fh.read().decode("utf-8", "replace")
            except OSError:
                continue
            split = _split_validate(text)
            if split is not None:
                return PublishedModel(gen, path, split[0], split[1])
        return None

    def next_generation(self) -> int:
        gens = generation_paths(self.pub_dir)
        return (gens[0][0] + 1) if gens else 1

    # -- publication ---------------------------------------------------------
    def publish(self, model_text: str, meta: Optional[Dict[str, Any]] = None,
                generation: Optional[int] = None) -> PublishedModel:
        """Atomically publish one generation; returns the record.

        `generation` overrides the auto-assigned number — the continuous
        trainer uses this to REPUBLISH a cycle whose original publish was
        torn or never landed (overwriting a torn file of the same number
        is safe: the replacement rename is atomic and carries the same
        bytes an uninterrupted run would have published).
        """
        gen = int(generation) if generation is not None \
            else self.next_generation()
        full_meta = dict(meta or {})
        full_meta.setdefault("generation", gen)
        full_meta.setdefault("published_at", resilience.wallclock())
        # machine-usable publish stamp: subscribers measure
        # model staleness against this without parsing the wallclock
        full_meta.setdefault("published_unix", round(time.time(), 3))
        body = _with_publish_footer(model_text, full_meta)
        path = os.path.join(self.pub_dir, _gen_name(gen))
        self._publish_count += 1
        # fault seam: a torn non-atomic write + abrupt death (the write
        # discipline this publisher exists to make impossible) …
        resilience.maybe_torn_publish(path, body, self._publish_count)
        resilience.atomic_write(path, body)
        # … and an abrupt death in the rename→manifest window
        resilience.maybe_die_at_publish(self._publish_count)
        self._write_manifest(gen, path, body)
        self._prune()
        # source end of the publish→subscriber flow arrow:
        # the flow id is derived from what BOTH ends read out of the
        # meta footer, so a subscriber in another process computes the
        # same id at swap-in and the merged timeline draws the link
        tracing.flow_start(
            "publish gen=%d" % gen,
            tracing.flow_id(full_meta.get("trace") or "no-trace", gen),
            generation=gen, trace=full_meta.get("trace"))
        return PublishedModel(gen, path, model_text, full_meta)

    def _write_manifest(self, gen: int, path: str, body: str) -> None:
        manifest = {
            "latest": gen,
            "file": os.path.basename(path),
            "sha256": hashlib.sha256(body.encode()).hexdigest(),
            "published_at": resilience.wallclock(),
            "keep_last": self.keep_last,
            "grace_s": self.grace_s,
        }
        resilience.atomic_write(os.path.join(self.pub_dir, MANIFEST),
                                json.dumps(manifest, indent=1))

    def publish_manifest(self, kind: str, section: Dict[str, Any]) -> str:
        """Publish one role's warm-start shape manifest alongside the
        generations: `runtime/warmup.py` merges the section
        into the dir's checksummed ``warmup.json`` atomically, so a
        fresh consumer can precompile the lineage's real shapes before
        admitting traffic.  Returns the manifest path."""
        from . import warmup
        return warmup.write_manifest(self.pub_dir, kind, section)

    def record_rejection(self, model_text: str, gate: Dict[str, Any],
                         cycle: int) -> str:
        """Persist a gate-REJECTED candidate for the audit trail:
        ``rejected_<cycle>.txt`` carries the full rejected
        model text with the same checksummed footer a publication gets —
        the meta holds the gate record (candidate metrics, incumbent
        metrics, tolerance, verdict) — but the ``rejected_`` name keeps
        it invisible to every subscriber.  Returns the path."""
        meta = {"rejected": True, "cycle": int(cycle), "gate": gate,
                "rejected_at": resilience.wallclock()}
        body = _with_publish_footer(model_text, meta)
        path = os.path.join(self.pub_dir,
                            "%s%08d%s" % (_REJECT_PREFIX, cycle,
                                          _GEN_SUFFIX))
        resilience.atomic_write(path, body)
        return path

    def _prune(self) -> None:
        """keep-last-K AND older-than-grace: both conditions must hold
        before a generation is unlinked (satellite pin: a subscriber that
        just resolved a path must get to read it).  A generation the
        rollback marker names as a PIN TARGET is never pruned — after a
        quality rollback the whole fleet is serving it, however old it
        is."""
        if self.keep_last <= 0:
            return
        cutoff = time.time() - max(self.grace_s, 0.0)
        protected = set(read_rollback_marker(self.pub_dir).get("pinned", []))
        for gen, old in generation_paths(self.pub_dir)[self.keep_last:]:
            if gen in protected:
                continue
            with contextlib.suppress(OSError):
                if self.grace_s <= 0 or os.path.getmtime(old) < cutoff:
                    os.unlink(old)


class ModelSubscriber:
    """Read-side resolution of the newest valid generation.

    ``resolve()`` returns a `PublishedModel` whose bytes were validated
    in the same pass that read them; torn/corrupt/vanished generations
    are skipped (and counted in ``skipped_invalid`` — the chaos soak's
    corruption ledger is exactly this counter staying at the number of
    faults injected, with ``corrupt_observed`` at zero).  When NOTHING
    valid exists yet (subscriber raced the very first publish), it
    retries with bounded jittered backoff before raising
    `NoValidGeneration`.
    """

    def __init__(self, pub_dir: str, attempts: int = 4,
                 backoff_base: float = 0.05, backoff_cap: float = 0.5,
                 seed: int = 0):
        self.pub_dir = pub_dir
        self.attempts = max(int(attempts), 1)
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.seed = seed
        self.skipped_invalid = 0         # torn/corrupt files stepped past
        self.skipped_rolled_back = 0     # marker-condemned gens stepped past
        self.resolved_count = 0
        self._pin: Optional[Tuple[int, Optional[int]]] = None

    # -- quality rollback ----------------------------
    def pin_generation(self, generation: int,
                       release_above: Optional[int] = None) -> None:
        """Roll this subscriber back: resolve `generation` (and only it)
        until either the pin is released (`unpin`) or — when
        `release_above` is given — a generation NEWER than
        `release_above` lands, i.e. the trainer has published a fresh
        candidate that deserves its own canary window.  The pin is
        runtime-local and immediate; the durable fleet-wide counterpart
        is the publish dir's ROLLBACK marker (`mark_rollback`), which
        every resolve consults."""
        self._pin = (int(generation), release_above)

    def unpin(self) -> None:
        self._pin = None

    def read_warmup(self, kind: str):
        """(warm-start manifest section, reason) for this publish dir —
        the consumer half of the seam (see
        `ModelPublisher.publish_manifest`)."""
        from . import warmup
        return warmup.read_manifest(self.pub_dir, kind)

    @property
    def pinned_generation(self) -> Optional[int]:
        return self._pin[0] if self._pin is not None else None

    def _bad_generations(self) -> set:
        return set(read_rollback_marker(self.pub_dir).get(
            "bad_generations", []))

    def _candidates(self) -> List[Tuple[int, str]]:
        """Generation candidates newest-first: the manifest pointer is
        tried first (one read instead of a directory scan in the common
        case), then the scan — a stale or torn manifest only costs the
        fallback, and a manifest pointing at a BETTER generation than the
        scan can see cannot happen (the generation file is renamed into
        place before the manifest names it)."""
        cands: List[Tuple[int, str]] = []
        try:
            with open(os.path.join(self.pub_dir, MANIFEST)) as fh:
                m = json.load(fh)
            cands.append((int(m["latest"]),
                          os.path.join(self.pub_dir, str(m["file"]))))
        except (OSError, ValueError, KeyError, TypeError):
            pass
        seen = {c[0] for c in cands}
        cands.extend((g, p) for g, p in generation_paths(self.pub_dir)
                     if g not in seen)
        cands.sort(reverse=True)
        return cands

    def resolve_once(self) -> Optional[PublishedModel]:
        """One resolution attempt (no retry).  Never raises on torn or
        vanishing files — those are skipped, as are generations the
        publish dir's ROLLBACK marker condemns.  While a pin is active
        the pinned generation is resolved instead of the newest one —
        until a candidate newer than the pin's `release_above` bound
        appears, which releases the pin (the fresh candidate gets its
        own canary judgment)."""
        bad = self._bad_generations()
        cands = self._candidates()
        if self._pin is not None:
            pin_gen, release_above = self._pin
            newest_ok = max((g for g, _ in cands
                             if g not in bad), default=None)
            if release_above is not None and newest_ok is not None \
                    and newest_ok > release_above:
                self._pin = None
            else:
                cands = [(g, p) for g, p in cands if g == pin_gen] or cands
        for gen, path in cands:
            if gen in bad:
                self.skipped_rolled_back += 1
                continue
            try:
                with open(path, "rb") as fh:
                    text = fh.read().decode("utf-8", "replace")
            except OSError:
                continue                 # pruned between listing and open
            split = _split_validate(text)
            if split is None:
                self.skipped_invalid += 1
                continue
            self.resolved_count += 1
            return PublishedModel(gen, path, split[0], split[1])
        return None

    def resolve(self) -> PublishedModel:
        delays = resilience.backoff_delays(self.attempts,
                                           base=self.backoff_base,
                                           cap=self.backoff_cap,
                                           seed=self.seed)
        for a in range(self.attempts):
            rec = self.resolve_once()
            if rec is not None:
                return rec
            if a < len(delays):
                time.sleep(delays[a])
        raise NoValidGeneration(
            "no valid published generation in %r after %d attempts"
            % (self.pub_dir, self.attempts))
