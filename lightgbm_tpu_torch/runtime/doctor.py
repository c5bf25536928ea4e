"""One-call debug bundle (counterpart of lightgbm_tpu/runtime/doctor.py).

Packages what a post-mortem needs into one atomic tar with a checksummed
manifest:

* **environment fingerprint** (`env_fingerprint`): python, torch, CUDA
  and numpy versions, the platform, argv, every ``LGBM_* / CUDA_* /
  TORCH_* / NVIDIA_*`` environment variable, whether CUDA is initialized
  in this process, the card's name and power limit from ``nvidia-smi``
  (a subprocess: the fingerprint never initializes CUDA), and the
  caller's parameters;
* **stage trails**: ``$LGBM_TPU_STAGE_REPORT`` and any trail files
  passed (read through the tolerant `read_stage_report`, so a torn trail
  ships as its raw bytes);
* **metrics snapshot**: the telemetry registry;
* **program ledger**: `graph_obs.LEDGER.to_json()` (per-site builds,
  wall times, last shapes, steady-state rebuilds);
* **build cache**: `warmup.cache_status()`;
* **trace ring**: the flight recorder's events as Chrome trace JSON;
* **recent artifacts**: the newest ``BENCH_* / CHAOS* / MULTICHIP*``
  JSONs found in the artifact directory (size-capped).

The bundle is written tmp + fsync + rename (one atomic file); the
manifest inside carries a sha256 per member and `verify_bundle` re-hashes
them.  Collection never raises out of the crashing process: each member
is gathered under its own guard, and one that cannot be gathered becomes
an ``errors`` entry of the manifest.  The CLI's ``task=doctor`` and its
crash-path bundle come with the CLI (ROADMAP queue A item 4).
"""
from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import platform
import subprocess
import sys
import tarfile
import time
from typing import Any, Dict, List, Optional

from . import graph_obs, resilience, telemetry, tracing, warmup

__all__ = ["collect_debug_bundle", "verify_bundle", "env_fingerprint"]

#: newest-first artifact globs bundled from the artifact directory
ARTIFACT_GLOBS = ("BENCH_r*.json", "BENCH_local*.json", "CHAOS*.json",
                  "MULTICHIP*.json")

#: per-member size cap: a bundle stays shippable over a bad link
MAX_MEMBER_BYTES = 1 << 20

#: artifacts bundled at most (newest by mtime)
MAX_ARTIFACTS = 8

#: environment prefixes the fingerprint records
ENV_PREFIXES = ("LGBM_", "CUDA_", "TORCH_", "NVIDIA_", "PYTORCH_")


def _nvidia_smi(timeout: float = 10.0) -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s answer, or why there
    is none."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        return "unavailable (%s: %s)" % (type(e).__name__, e)
    if r.returncode != 0:
        return "unavailable (rc %d: %s)" % (r.returncode,
                                            (r.stderr or "").strip()[:200])
    return r.stdout.strip()


def env_fingerprint(config: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Everything about WHERE this ran that a post-mortem asks first.
    Reads torch only if it is imported, and CUDA only if this process has
    initialized it."""
    env_keys = sorted(k for k in os.environ if k.startswith(ENV_PREFIXES))
    fp: Dict[str, Any] = {
        "wallclock": resilience.wallclock(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "cwd": os.getcwd(),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "env": {k: os.environ[k] for k in env_keys},
        "nvidia_smi": _nvidia_smi(),
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        fp["torch_version"] = getattr(torch, "__version__", "?")
        fp["torch_cuda"] = torch.version.cuda
        fp["cuda_initialized"] = bool(torch.cuda.is_initialized())
        if fp["cuda_initialized"]:
            fp["cuda_device"] = torch.cuda.get_device_name(
                torch.cuda.current_device())
    np = sys.modules.get("numpy")
    if np is not None:
        fp["numpy_version"] = getattr(np, "__version__", "?")
    if config:
        fp["config"] = {str(k): str(v) for k, v in config.items()}
    return fp


def _stage_trail_members(extra: Optional[List[str]]) -> Dict[str, bytes]:
    out: Dict[str, bytes] = {}
    paths: List[str] = []
    p = os.environ.get("LGBM_TPU_STAGE_REPORT")
    if p:
        paths.append(p)
    paths.extend(extra or [])
    for i, p in enumerate(paths):
        if not os.path.exists(p):
            continue
        name = "trails/%d_%s" % (i, os.path.basename(p))
        rep = resilience.read_stage_report(p)
        if rep is not None:
            out[name] = (json.dumps(rep, indent=1) + "\n").encode("utf-8")
        else:
            with open(p, "rb") as fh:        # torn: raw bytes beat nothing
                out[name] = fh.read(MAX_MEMBER_BYTES)
    return out


def _artifact_members(artifact_dir: str) -> Dict[str, bytes]:
    found: List[str] = []
    for pat in ARTIFACT_GLOBS:
        found.extend(glob.glob(os.path.join(artifact_dir, pat)))
    found = sorted(set(found), key=os.path.getmtime, reverse=True)
    out: Dict[str, bytes] = {}
    for p in found[:MAX_ARTIFACTS]:
        with open(p, "rb") as fh:
            out["artifacts/" + os.path.basename(p)] = \
                fh.read(MAX_MEMBER_BYTES)
    return out


def _metrics_member() -> bytes:
    return (json.dumps(telemetry.snapshot("doctor")) + "\n").encode("utf-8")


def collect_debug_bundle(out_dir: str = ".",
                         tag: Optional[str] = None,
                         config: Optional[Dict[str, Any]] = None,
                         stage_reports: Optional[List[str]] = None,
                         artifact_dir: Optional[str] = None,
                         note: Optional[str] = None) -> Dict[str, Any]:
    """Collect everything into ``<out_dir>/lgbm_debug_<stamp>.tar.gz``
    atomically.  Returns ``{"path": ..., "manifest": {...}}``; the same
    manifest (a sha256 per member) rides in the tar as
    ``manifest.json``."""
    stamp = time.strftime("%Y%m%d_%H%M%S")
    name = "lgbm_debug_%s%s_%d" % (("%s_" % tag) if tag else "", stamp,
                                   os.getpid())
    members: Dict[str, bytes] = {}
    errors: Dict[str, str] = {}

    def gather(member: str, fn) -> None:
        try:
            v = fn()
            if isinstance(v, dict):
                v = (json.dumps(v, indent=1) + "\n").encode("utf-8")
            if v:
                members[member] = v[:MAX_MEMBER_BYTES] \
                    if isinstance(v, bytes) else v
        except Exception as e:   # noqa: BLE001 — collection must not crash
            errors[member] = "%s: %s" % (type(e).__name__, e)

    gather("env.json", lambda: env_fingerprint(config))
    gather("metrics.json", _metrics_member)
    gather("graph_ledger.json", lambda: graph_obs.LEDGER.to_json())
    gather("warmup_status.json", warmup.cache_status)
    gather("trace.json", lambda: tracing.export_chrome(
        context_name="doctor"))
    try:
        members.update(_stage_trail_members(stage_reports))
    except Exception as e:       # noqa: BLE001
        errors["trails"] = "%s: %s" % (type(e).__name__, e)
    try:
        members.update(_artifact_members(
            artifact_dir if artifact_dir is not None else os.getcwd()))
    except Exception as e:       # noqa: BLE001
        errors["artifacts"] = "%s: %s" % (type(e).__name__, e)

    manifest: Dict[str, Any] = {
        "bundle": name,
        "created": resilience.wallclock(),
        "members": [
            {"name": m, "sha256": hashlib.sha256(members[m]).hexdigest(),
             "bytes": len(members[m])}
            for m in sorted(members)],
    }
    if note:
        manifest["note"] = note
    if errors:
        manifest["errors"] = errors

    out_path = os.path.join(out_dir, name + ".tar.gz")
    tmp = out_path + ".tmp.%d" % os.getpid()
    with tarfile.open(tmp, "w:gz") as tar:
        def add(member_name: str, data: bytes) -> None:
            info = tarfile.TarInfo(name + "/" + member_name)
            info.size = len(data)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(data))
        add("manifest.json",
            (json.dumps(manifest, indent=1) + "\n").encode("utf-8"))
        for m in sorted(members):
            add(m, members[m])
    with open(tmp, "rb") as fh:           # fsync before the atomic rename
        os.fsync(fh.fileno())
    os.replace(tmp, out_path)
    return {"path": out_path, "manifest": manifest}


def verify_bundle(path: str) -> Dict[str, Any]:
    """Re-read a bundle and re-hash every member against its manifest:
    {"ok": bool, "bundle": name, "members": N, "mismatches": [...]}."""
    with tarfile.open(path, "r:gz") as tar:
        by_name = {}
        root = None
        for info in tar.getmembers():
            parts = info.name.split("/", 1)
            if len(parts) != 2:
                continue
            root = parts[0]
            by_name[parts[1]] = tar.extractfile(info).read()
        manifest = json.loads(by_name.pop("manifest.json").decode("utf-8"))
    mismatches: List[str] = []
    for entry in manifest["members"]:
        data = by_name.get(entry["name"])
        if data is None:
            mismatches.append("%s: missing from tar" % entry["name"])
        elif hashlib.sha256(data).hexdigest() != entry["sha256"]:
            mismatches.append("%s: sha256 mismatch" % entry["name"])
    for extra in sorted(set(by_name) - {e["name"]
                                        for e in manifest["members"]}):
        mismatches.append("%s: in tar but not in manifest" % extra)
    return {"ok": not mismatches, "bundle": root,
            "members": len(manifest["members"]), "mismatches": mismatches}
