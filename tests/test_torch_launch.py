"""Multi-process launch of the port: the reference's machine-list config
onto torch.distributed (lightgbm_tpu_torch/parallel/launch.py; the port's
counterpart of tests/test_launch.py).

List parsing, rank-by-own-position resolution, the same-host port
tie-break and the single-machine early out are checked in this process;
two spawned ranks (tests/torch_dist_worker.py) bring real groups up from
one machine list of free localhost ports: through init_distributed (with
an object gather and the telemetry gather over it), through the C ABI's
LGBM_NetworkInit / LGBM_NetworkFree, and through the CLI training
tree_learner=data, whose two ranks write one model.
"""
import socket

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import capi
from lightgbm_tpu_torch.parallel import launch
from lightgbm_tpu_torch.parallel.launch import (init_distributed,
                                                 parse_machine_list,
                                                 resolve_rank)

import torch_dist_worker as W

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


def test_parse_machines_string():
    assert parse_machine_list("10.0.0.1:123,10.0.0.2:456") == [
        ("10.0.0.1", 123), ("10.0.0.2", 456)]
    # the port defaults to local_listen_port (config.h's 12400)
    assert parse_machine_list("a,b", default_port=777) == [
        ("a", 777), ("b", 777)]


def test_parse_machine_list_file(tmp_path):
    f = tmp_path / "mlist.txt"
    f.write_text("# cluster\n10.0.0.1 123\n10.0.0.2:456\n"
                 "10.0.0.3\t789\n10.0.0.4   321\n   # standby\n\n")
    assert parse_machine_list(machine_list_filename=str(f)) == [
        ("10.0.0.1", 123), ("10.0.0.2", 456), ("10.0.0.3", 789),
        ("10.0.0.4", 321)]
    with pytest.raises(ValueError):
        parse_machine_list()


def test_resolve_rank_same_host_port_tiebreak():
    """Same-host lists rank by the port (linkers_socket.cpp:37 matches ip
    AND port)."""
    mlist = [("127.0.0.1", 12400), ("127.0.0.1", 12401)]
    assert resolve_rank(mlist, local_listen_port=12401) == 1
    assert resolve_rank(mlist, local_listen_port=12400) == 0
    with pytest.raises(ValueError, match="several"):
        resolve_rank(mlist)
    with pytest.raises(ValueError, match="does not pick exactly one"):
        resolve_rank(mlist, local_listen_port=9999)


def test_resolve_rank_explicit_and_env(monkeypatch):
    mlist = [("a", 1), ("b", 2), ("c", 3)]
    assert resolve_rank(mlist, node_rank=2) == 2
    monkeypatch.setenv("LIGHTGBM_TPU_NODE_RANK", "1")
    assert resolve_rank(mlist) == 1
    with pytest.raises(ValueError):
        resolve_rank(mlist, node_rank=3)


def test_resolve_rank_by_local_address():
    mlist = [("10.255.0.9", 1), (socket.gethostname(), 2)]
    assert resolve_rank(mlist) == 1
    mlist2 = [("127.0.0.1", 1), ("10.255.0.9", 2)]
    assert resolve_rank(mlist2) == 0
    with pytest.raises(ValueError):
        resolve_rank([("10.255.0.9", 1)])


def test_single_machine_early_out():
    """One machine: no group (Network::Init's early out), and the public
    entry point is this function."""
    import torch.distributed as dist
    assert lt.init_distributed is init_distributed
    assert init_distributed(machines="127.0.0.1:12400") == 0
    assert not dist.is_initialized()


def _xy(n=400, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 5)).astype(np.float32)
    return X, (X[:, 0] > 0).astype(np.float32)


def test_booster_with_single_machine_config():
    X, y = _xy()
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "device_type": "cpu", "machines": "127.0.0.1:12400"},
                   lt.Dataset(X, label=y), num_boost_round=2)
    assert bst.current_iteration() == 2


def test_machine_list_file_ignored_when_num_machines_1():
    """The reference's example confs carry a machine list next to
    num_machines = 1 and never read the file."""
    X, y = _xy()
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "device_type": "cpu",
                    "machine_list_filename": "this_file_does_not_exist.txt",
                    "num_machines": 1, "local_listen_port": 12400},
                   lt.Dataset(X, label=y), num_boost_round=2)
    assert bst.current_iteration() == 2


def test_inline_machines_with_explicit_num_machines_1_stays_serial():
    """An explicit num_machines=1 beside an inline list means serial (the
    binding lets the explicit param win, basic.py:1483): the two-peer list
    would otherwise block waiting for a peer."""
    from lightgbm_tpu_torch.config import Config
    ml = "127.0.0.1:12400,10.255.255.1:12400"
    assert launch.maybe_init_distributed(
        Config({"objective": "binary", "num_machines": 1,
                "machines": ml})) is None
    assert launch.maybe_init_distributed(
        {"num_machines": 1, "machines": ml}) is None
    X, y = _xy()
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                    "device_type": "cpu", "num_machines": 1,
                    "machines": ml}, lt.Dataset(X, label=y),
                   num_boost_round=2)
    assert bst.current_iteration() == 2


def test_inline_machines_without_explicit_count_still_derives(monkeypatch):
    """num_machines unset: an inline two-peer list implies a parallel run
    (the binding derives the count from len(machines)), and time_out in
    minutes becomes the bring-up's seconds."""
    called = {}

    def fake_init(machines=None, machine_list_filename=None,
                  local_listen_port=12400, **kwargs):
        called.update(kwargs, machines=machines)
        return 0

    monkeypatch.setattr(launch, "init_distributed", fake_init)
    rank = launch.maybe_init_distributed(
        {"machines": "127.0.0.1:12400,10.255.255.1:12400", "time_out": 2})
    assert rank == 0 and called["machines"] and called["timeout_s"] == 120


def test_bring_up_timeout_names_the_store():
    """A store nobody serves fails within the timeout, naming it and the
    rank, instead of hanging."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with pytest.raises(RuntimeError, match="127.0.0.1:%d" % port):
        launch.init_group("tcp://127.0.0.1:%d" % port, world_size=2, rank=1,
                          timeout_s=2, attempts=1)


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    X, y = _xy(n=1200, seed=5)
    data = tmp / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.7g")
    capi.ensure_built(train=True)
    p = _free_ports(6)
    ports = [p[0:2], p[2:4], p[4:6]]
    return W.run_ranks(tmp, "launch", (ports, str(data), str(tmp)),
                       world=2, timeout=240, group=False)


def test_two_process_localhost_distributed_smoke(launched):
    """Two processes rank themselves by the port tie-break on one machine
    list and bring a group up with rank 0's entry as the store, kept when
    asked again (idempotent); an object gather and the telemetry gather
    cross it; shutdown tears it down."""
    for r, out in enumerate(launched):
        assert out["rank"] == r and out["again"] == r
        assert out["world"] == 2
        assert out["gathered"] == [("rank", 0), ("rank", 1)]
        assert out["hosts"] == ["0", "1"]
        assert out["down"]


def test_c_abi_brings_two_ranks_up(launched):
    for r, out in enumerate(launched):
        assert out["capi_world"] == 2 and out["capi_rank"] == r
        assert out["capi_down"]


def test_cli_trains_over_two_ranks(launched):
    """task=train with a two-machine list and tree_learner=data: each
    rank's model file is the same, and the group goes with the run."""
    def model(out):
        # the parameters section names each rank's own listen port
        return [ln for ln in out["cli_model"].splitlines()
                if not ln.startswith("[local_listen_port:")]

    a, b = launched
    assert model(a) == model(b)
    assert "Tree=2" in a["cli_model"]
    assert "[tree_learner: data]" in a["cli_model"]
    assert a["cli_down"] and b["cli_down"]
