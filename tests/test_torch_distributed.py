"""Port parity: multi-host plumbing of ``dis_tpu_torch.parallel``
(``distributed.py`` and ``launch.py``), on the CPU.

- ``init_multi_host`` reads torch's launcher variables, explicit
  arguments winning, with ``torch.distributed.init_process_group``
  patched; no master address (or world size 1, no backend named) starts
  no group; a CUDA device is never swapped for another.
- ``shard_frame_range`` (a copy) equals the JAX package's over a grid.
- Two hosts shard a 40x48 sequence through ``run_sequence_shard`` in
  worker processes with no master address (the shards need no
  collective, as ``tests/test_multihost.py``'s workers need no
  coordinator); host 1 is killed after one pair and relaunched with the
  same command line; every ``.flo`` equals the serial port run bitwise.
- ``scaling_report`` runs its ranks (gloo, 1 and 2 ranks) and reports.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dis_tpu.parallel.distributed import shard_frame_range as jshard_frame_range
from dis_tpu_torch.config import DISConfig
from dis_tpu_torch.parallel import distributed as tdist
from dis_tpu_torch.parallel.launch import default_backend, rank_device

from conftest import synthetic_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def fake_init(monkeypatch):
    calls = []
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(tdist.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tdist.dist, "init_process_group",
                        lambda backend, **kw: calls.append(dict(backend=backend, **kw)))
    return calls


def test_init_multi_host_env_plumbing(fake_init, monkeypatch):
    calls = fake_init
    assert tdist.init_multi_host(device="cpu") == torch.device("cpu")
    assert calls == []                      # no master address: no group
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    assert tdist.init_multi_host() == torch.device("cuda", 0)
    assert calls == []                      # world size 1: no group
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tdist.init_multi_host(device="cpu") == torch.device("cpu")
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                      "world_size": 4, "rank": 2}]
    # explicit arguments win over the environment
    tdist.init_multi_host(backend="nccl", master_addr="host", master_port=9, world_size=8,
                          rank=7, device="cpu")
    assert calls[-1] == {"backend": "nccl", "init_method": "tcp://host:9",
                         "world_size": 8, "rank": 7}
    # a named backend starts a group of one
    tdist.init_multi_host(backend="gloo", world_size=1, rank=0, device="cpu")
    assert calls[-1]["world_size"] == 1 and calls[-1]["init_method"] == "tcp://10.0.0.1:1234"


def test_init_multi_host_never_swaps_the_device(fake_init, monkeypatch):
    """The default device is cuda:<LOCAL_RANK>; without that card it
    raises instead of running on another device."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.init_multi_host()
    assert fake_init == []


def test_launch_device_and_backend_rules(monkeypatch):
    assert rank_device("cpu", 3) == torch.device("cpu")
    assert default_backend("cuda") == "nccl"
    assert default_backend("cuda:0") == "gloo"
    assert default_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_device("cuda", 0) == torch.device("cuda", 0)
    assert rank_device("cuda:0", 3) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="has 1 CUDA device"):
        rank_device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device("cuda:0", 0)


@pytest.mark.parametrize("num_hosts", [1, 2, 3, 4])
@pytest.mark.parametrize("total", [0, 1, 7, 8])
def test_shard_frame_range_matches_jax(num_hosts, total):
    start, end = 3, 3 + total
    seen = []
    for hid in range(num_hosts):
        got = tdist.shard_frame_range(start, end, num_hosts, hid)
        assert got == jshard_frame_range(start, end, num_hosts, hid)
        seen.extend(range(*got))
    assert seen == list(range(start, end))
    with pytest.raises(ValueError):
        tdist.shard_frame_range(start, end, num_hosts, num_hosts)


def _host(tmp_path, host_id, die_after=0):
    """Host ``host_id`` of 2 on pairs [1, 8) of ``tmp_path/seq``, a
    worker process (``tests/torch_ranks.py::shard_worker``)."""
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(WORLD_SIZE="2", RANK=str(host_id))
    folder, ck, out = (str(tmp_path / d) for d in ("seq", "ck", "out"))
    code = (f"import sys; sys.path[:0] = [{TESTS!r}, {REPO!r}]; import torch_ranks; "
            f"torch_ranks.shard_worker({folder!r}, 1, 8, {ck!r}, {out!r}, {die_after})")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def test_two_hosts_kill_resume_match_serial(tmp_path):
    from dis_tpu_torch.runner import run_sequence
    from dis_tpu_torch.utils.flo import load_flo
    from dis_tpu_torch.utils.io import imwrite

    seq = tmp_path / "seq"
    seq.mkdir()
    cur = np.clip(synthetic_pair(40, 48, seed=42)[0], 0, 255)
    for t in range(8):   # pairs 1..7, sharded [1, 5) / [5, 8)
        imwrite(str(seq / f"frame_{t + 1:04d}.png"), cur.astype(np.uint8))
        cur = np.roll(cur, shift=1, axis=1)
    h0, h1 = _host(tmp_path, 0), _host(tmp_path, 1, die_after=1)
    out0, err0 = h0.communicate(timeout=300)
    _, err1 = h1.communicate(timeout=300)
    assert h0.returncode == 0, err0[-2000:]
    assert out0.split("SUMMARY")[1].split() == ["1", "5", "1", "4"]
    assert h1.returncode == 17, err1[-2000:]        # killed after one pair
    h1 = _host(tmp_path, 1)                           # relaunched, same command line
    out1, err1 = h1.communicate(timeout=300)
    assert h1.returncode == 0, err1[-2000:]
    assert out1.split("SUMMARY")[1].split() == ["5", "8", "6", "2"]

    cfg = DISConfig(iterations=4, coarsest_scale=2, patch_overlap=0.5, early_exit=False)
    run_sequence(str(seq), 1, 8, cfg, out_dir=str(tmp_path / "serial"), save_flo=True,
                 device="cpu")
    for i in range(1, 8):
        name = f"frame_{i:04d}.flo"
        got = load_flo(str(tmp_path / "out" / name))
        want = load_flo(str(tmp_path / "serial" / name))
        assert got.shape == (40, 48, 2) and np.array_equal(got, want), name


def test_scaling_report_runs_its_ranks():
    cfg = DISConfig(iterations=2, coarsest_scale=2, patch_overlap=0.5, mode="fixed",
                    early_exit=False)
    rep = tdist.scaling_report(cfg, 32, 32, device_counts=[1, 2], device="cpu")
    assert rep["platform"] == "cpu"
    assert [r["devices"] for r in rep["rows"]] == [1, 2]
    assert rep["rows"][0]["efficiency"] == 1.0
    assert all(r["pairs_per_sec"] > 0 for r in rep["rows"])
