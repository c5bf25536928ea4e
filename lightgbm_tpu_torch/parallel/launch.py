"""Multi-process launch: the reference's machine-list network config onto
`torch.distributed.init_process_group` (counterpart of
lightgbm_tpu/parallel/launch.py).

The reference brings up its own socket collective network from
`machines` / `machine_list_filename` + `local_listen_port`
(src/network/linkers_socket.cpp: every host holds the full machine list;
its rank is the position of its own ip:port pair in that list).  Here the
transport is a torch.distributed process group (gloo), whose store
listens at the first machine of the list, so a reference-style cluster
config launches a run unchanged:

    import lightgbm_tpu_torch as lt
    lt.init_distributed(machines="10.0.0.1:12400,10.0.0.2:12400")
    # ... then lt.train(params with tree_learner=data ...)

Rank resolution order: an explicit `node_rank` argument, the
LIGHTGBM_TPU_NODE_RANK environment variable, then matching this host's
addresses against the list (ties between several local entries, the
same-host multi-process layout, break on `local_listen_port`: the
reference's ip AND port match, linkers_socket.cpp:37).
"""
from __future__ import annotations

import datetime
import os
import socket
import time
from typing import List, Optional, Tuple

from ..runtime import resilience
from ..utils.log import Log

__all__ = ["parse_machine_list", "resolve_rank", "init_distributed",
           "maybe_init_distributed", "shutdown_distributed"]


def parse_machine_list(machines: str = None,
                       machine_list_filename: str = None,
                       default_port: int = 12400) -> List[Tuple[str, int]]:
    """[(host, port), ...] from the reference's two config spellings:
    `machines` = "ip1:port1,ip2:port2" (port optional), or a machine-list
    file with one "ip port" or "ip:port" per line (config.h `machines` /
    `machine_list_filename` docs)."""
    entries: List[str] = []
    if machines:
        entries = [m.strip() for m in machines.split(",") if m.strip()]
    elif machine_list_filename:
        with open(machine_list_filename) as fh:
            for ln in fh:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                entries.append(":".join(ln.replace(":", " ").split()))
    if not entries:
        raise ValueError(
            "init_distributed needs `machines` or `machine_list_filename`")
    out = []
    for e in entries:
        if ":" in e:
            host, port = e.rsplit(":", 1)
            out.append((host, int(port)))
        else:
            out.append((e, default_port))
    return out


def _local_addresses() -> set:
    names = {socket.gethostname(), "localhost", "127.0.0.1", "::1"}
    try:
        host, aliases, addrs = socket.gethostbyname_ex(socket.gethostname())
        names.update([host, *aliases, *addrs])
    except OSError:
        pass
    return names


def resolve_rank(machine_list: List[Tuple[str, int]],
                 node_rank: Optional[int] = None,
                 local_listen_port: Optional[int] = None) -> int:
    """This process's rank = the position of its own ip:port pair in the
    list (reference Network::Init / linkers_socket.cpp:37).  An explicit
    node_rank (argument or LIGHTGBM_TPU_NODE_RANK) wins; otherwise local
    interface addresses are matched, with ties between several local
    entries (same-host multi-process) broken by `local_listen_port`."""
    if node_rank is None and os.environ.get("LIGHTGBM_TPU_NODE_RANK"):
        node_rank = int(os.environ["LIGHTGBM_TPU_NODE_RANK"])
    if node_rank is not None:
        if not (0 <= node_rank < len(machine_list)):
            raise ValueError("node_rank %d outside machine list of %d"
                             % (node_rank, len(machine_list)))
        return node_rank
    local = _local_addresses()

    def is_local(host: str) -> bool:
        if host in local:
            return True
        try:
            return socket.gethostbyname(host) in local
        except OSError:
            return False

    matches = [i for i, (host, _p) in enumerate(machine_list)
               if is_local(host)]
    if len(matches) > 1 and local_listen_port is not None:
        port_matches = [i for i in matches
                        if machine_list[i][1] == local_listen_port]
        if len(port_matches) == 1:
            return port_matches[0]
        raise ValueError(
            "several machine-list entries are this host and "
            "local_listen_port=%s does not pick exactly one of %r; "
            "pass node_rank= or set LIGHTGBM_TPU_NODE_RANK"
            % (local_listen_port, [machine_list[i] for i in matches]))
    if matches:
        if len(matches) > 1:
            raise ValueError(
                "several machine-list entries are this host %r; set "
                "local_listen_port per process, or node_rank= / "
                "LIGHTGBM_TPU_NODE_RANK"
                % ([machine_list[i] for i in matches],))
        return matches[0]
    raise ValueError(
        "none of this host's addresses appear in the machine list %r; "
        "pass node_rank= or set LIGHTGBM_TPU_NODE_RANK" % (machine_list,))


def _already_initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


#: bounded bring-up (the reference's linkers_socket.cpp retries its
#: connects under config.time_out rather than blocking forever); both can
#: be set from the environment
_INIT_TIMEOUT_S = int(os.environ.get("LIGHTGBM_TPU_INIT_TIMEOUT", "120"))
_INIT_ATTEMPTS = int(os.environ.get("LIGHTGBM_TPU_INIT_ATTEMPTS", "3"))


def init_group(init_method: str = None, world_size: int = 1,
               rank: int = 0, timeout_s: int = _INIT_TIMEOUT_S,
               attempts: int = _INIT_ATTEMPTS, store=None,
               backend: str = "gloo") -> None:
    """`torch.distributed.init_process_group` under a timeout (which
    also bounds every later collective, so a rank that dies cannot hang
    the others for ever) and a bounded jittered-backoff retry.  The final
    error names the store's address and this process's rank."""
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=max(int(timeout_s), 1))
    delays = resilience.backoff_delays(attempts, base=2.0, cap=15.0,
                                       seed=rank)
    last: Optional[BaseException] = None
    for a in range(max(attempts, 1)):
        try:
            dist.init_process_group(backend, init_method=init_method,
                                    store=store, world_size=world_size,
                                    rank=rank, timeout=timeout)
            return
        except Exception as e:   # refused connects, timeouts, DNS
            last = e
            if dist.is_initialized():
                dist.destroy_process_group()
            if a < len(delays):
                Log.warning(
                    "init_process_group attempt %d/%d failed (store %s, "
                    "rank %d/%d): %s; retrying in %.1fs", a + 1, attempts,
                    init_method or "given", rank, world_size, e, delays[a])
                time.sleep(delays[a])
    raise RuntimeError(
        "torch.distributed.init_process_group failed after %d attempt(s): "
        "the store at %s was not reached from rank %d of %d (last error: "
        "%s).  Check that the first machine is up, its port is open, and "
        "every machine-list entry resolves." % (
            max(attempts, 1), init_method or "the given store", rank,
            world_size, last)) from last


def init_distributed(machines: str = None,
                     machine_list_filename: str = None,
                     local_listen_port: int = 12400,
                     node_rank: Optional[int] = None,
                     timeout_s: Optional[int] = None,
                     attempts: Optional[int] = None) -> int:
    """Bring up the process group from a reference-style cluster config
    and return this process's rank.  The FIRST machine of the list holds
    the group's store (the reference roots its collectives at rank 0 the
    same way).  After this returns, `tree_learner=data|voting|feature`
    trains over every rank of the group.  Idempotent: a group already up
    is kept."""
    if _already_initialized():
        import torch.distributed as dist
        Log.info("torch.distributed already initialized; keeping the "
                 "existing group")
        return int(dist.get_rank())
    mlist = parse_machine_list(machines, machine_list_filename,
                               default_port=local_listen_port)
    if len(mlist) == 1:
        # one machine: nothing to coordinate, the reference's
        # num_machines == 1 path (Network::Init's early out)
        Log.info("machine list has one entry; no process group")
        return 0
    rank = resolve_rank(mlist, node_rank, local_listen_port)
    store = "tcp://%s:%d" % mlist[0]
    init_group(store, len(mlist), rank,
               timeout_s=_INIT_TIMEOUT_S if timeout_s is None else timeout_s,
               attempts=_INIT_ATTEMPTS if attempts is None else attempts)
    Log.info("torch.distributed up: %d processes, rank %d, store %s",
             len(mlist), rank, store)
    return rank


def shutdown_distributed() -> None:
    """Tear the process group down (LGBM_NetworkFree); a no-op without
    one."""
    if _already_initialized():
        import torch.distributed as dist
        dist.destroy_process_group()


def maybe_init_distributed(cfg) -> Optional[int]:
    """The Booster's and the CLI's gate: bring the group up from a
    Config-like object iff it describes a multi-machine run.  The
    reference calls Network::Init only when `num_machines > 1`
    (application.cpp:168-171): its example confs carry
    `machine_list_file = mlist.txt` beside `num_machines = 1` and never
    read the file.  An inline `machines` list implies the count, unless
    num_machines was given (the reference binding, basic.py:1470-1483)."""
    def get(key, default):
        if isinstance(cfg, dict):
            return cfg.get(key, default)
        return getattr(cfg, key, default)

    machines = get("machines", "") or ""
    mfile = get("machine_list_filename", "") or ""
    if not machines and not mfile:
        return None
    num_machines = int(get("num_machines", 1) or 1)
    if isinstance(cfg, dict):
        explicit = "num_machines" in cfg
    else:
        explicit = "num_machines" in getattr(cfg, "raw_params", {})
    if machines and not explicit:
        num_machines = max(num_machines,
                           len([m for m in machines.split(",")
                                if m.strip()]))
    if num_machines <= 1:
        return None
    port = int(get("local_listen_port", 12400) or 12400)
    # the reference's time_out is the connect budget in MINUTES (config.h)
    tmin = get("time_out", None)
    timeout_s = int(float(tmin) * 60) if tmin not in (None, "") else None
    return init_distributed(machines=machines or None,
                            machine_list_filename=mfile or None,
                            local_listen_port=port, timeout_s=timeout_s)
