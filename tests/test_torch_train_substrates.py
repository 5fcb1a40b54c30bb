"""What surrounds the port's train step, against the JAX package on the
CPU: checkpoints (the reference's layout, atomic, pruned, asynchronous,
readable by either package), the synthetic LM stream (bitwise, with
resume), the AMU-prefetching loader and ``DeviceTransferBackend``, the
fault-tolerance copies, and the train CLI on danube-smoke.

The CLI comparison starts both CLIs from one checkpoint of the JAX
``init_params`` (``--resume``), so both train the same weights on the
same stream with bf16 compute: over 6 steps their losses were measured
at most 5.8e-4 apart (from 6.8e-5 at the first step: bf16 products
round apart and Adam carries the difference on); the bar is 3e-3.
"""

import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.runtime import fault_tolerance as jft
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.amu import (AMU, AMUError, DeviceTransferBackend,
                                  FAILURE_CODE, RequestState)
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.launch import train_lm
from repro_torch.models.model import init_params
from repro_torch import tree as ttree
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import fault_tolerance as tft

ARCH = "h2o-danube-1.8b"
CLI_TOL = 3e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_state():
    cfg = tconfigs.get_smoke(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    opt = tadamw.adamw_init(params)
    opt = opt._replace(m=ttree.tree_map(lambda x: x + 0.25, opt.m),
                       step=torch.tensor(5, dtype=torch.int32))
    return params, opt


def same_tree(a, b):
    la, lb = ttree.leaves(a), ttree.leaves(b)
    assert len(la) == len(lb)
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_and_layout(tmp_path):
    params, opt = small_state()
    path = tckpt.save(tmp_path, 3, (params, opt), metadata={"step": 3})
    assert path == tmp_path / "step_00000003"
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["LATEST", "step_00000003"]
    assert sorted(p.name for p in path.iterdir()) == \
        ["manifest.json", "shard_0.npz"]
    assert (tmp_path / "LATEST").read_text() == "3"
    (rp, ro), meta = tckpt.restore(tmp_path, target=(params, opt))
    assert meta == {"step": 3}
    assert isinstance(ro, tadamw.OptState)
    assert same_tree(rp, params) and same_tree(ro.m, opt.m) \
        and same_tree(ro.v, opt.v)
    assert ro.step.dtype == torch.int32 and int(ro.step) == 5
    flat, _ = tckpt.restore(tmp_path, 3)
    assert len(flat) == len(ttree.leaves(params)) * 3 + 1


def test_checkpoint_shards_past_the_shard_size(tmp_path, monkeypatch):
    params, opt = small_state()
    monkeypatch.setattr(tckpt, "_SHARD_BYTES", 64 * 1024)
    path = tckpt.save(tmp_path, 1, (params, opt))
    shards = sorted(p.name for p in path.glob("shard_*.npz"))
    assert len(shards) > 2
    (rp, ro), _ = tckpt.restore(tmp_path, target=(params, opt))
    assert same_tree(rp, params) and same_tree(ro.v, opt.v)


def test_checkpoint_atomic_and_prune(tmp_path):
    params, opt = small_state()
    for s in (1, 2, 3, 4):
        tckpt.save(tmp_path, s, (params, opt), metadata={"step": s})
    # a writer killed mid-write leaves only its .tmp: never listed, and
    # LATEST still names the last finished checkpoint
    (tmp_path / "step_00000005.tmp").mkdir()
    assert tckpt.all_steps(tmp_path) == [1, 2, 3, 4]
    assert tckpt.latest_step(tmp_path) == 4
    tckpt.prune(tmp_path, keep=2)
    assert tckpt.all_steps(tmp_path) == [3, 4]
    assert tckpt.latest_step(tmp_path / "nowhere") is None
    assert tckpt.all_steps(tmp_path / "nowhere") == []
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "nowhere")


def test_async_save_holds_the_values_of_the_call(tmp_path):
    """The host copy is taken before ``save`` returns: the in-place
    update the next train step makes does not reach the file."""
    params, opt = small_state()
    before = ttree.tree_map(torch.clone, params)
    tckpt.save(tmp_path, 7, (params, opt), async_=True)
    for leaf in ttree.leaves(params):
        leaf.add_(1.0)
    tckpt.wait_pending()
    assert not tckpt._pending
    (rp, _), _ = tckpt.restore(tmp_path, target=(params, opt))
    assert same_tree(rp, before)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The reference reads the port's checkpoint of (params, OptState)
    and the port reads the reference's, leaf for leaf."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jax.jit(jmodel.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(1))
    jopt = jadamw.adamw_init(jp)._replace(step=jnp.asarray(9, jnp.int32))
    jckpt.save(tmp_path / "j", 9, (jp, jopt), metadata={"step": 9})
    params, opt = small_state()
    (rp, ro), meta = tckpt.restore(tmp_path / "j", target=(params, opt))
    assert meta == {"step": 9} and int(ro.step) == 9
    want = jax.tree_util.tree_leaves(jp)
    assert all(np.array_equal(x.numpy(), np.asarray(y))
               for x, y in zip(ttree.leaves(rp), want))
    tckpt.save(tmp_path / "t", 5, (params, opt), metadata={"step": 5})
    (jrp, jro), _ = jckpt.restore(tmp_path / "t", target=(jp, jopt))
    assert int(jro.step) == 5
    assert all(np.array_equal(np.asarray(y), x.numpy()) for x, y in zip(
        ttree.leaves(opt.m), jax.tree_util.tree_leaves(jro.m)))
    assert all(np.array_equal(np.asarray(y), x.numpy()) for x, y in zip(
        ttree.leaves(params), jax.tree_util.tree_leaves(jrp)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start_step", [0, 3])
def test_synthetic_lm_bitwise_the_reference(start_step):
    kw = dict(seed=11, start_step=start_step,
              extras={"src_embeds": ((5, 4), np.float32)})
    ref = jpipe.SyntheticLM(300, 16, 3, **kw)
    port = tpipe.SyntheticLM(300, 16, 3, **kw)
    for _ in range(4):
        a, b = next(port), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert port.step == ref.step == start_step + 4


def test_resume_continues_the_task_not_the_stream():
    """A stream resumed at step 3 draws the same (a, c) pool, other
    sequences, as in the reference."""
    a = tpipe.SyntheticLM(300, 16, 3, seed=11)
    b = tpipe.SyntheticLM(300, 16, 3, seed=11, start_step=3)
    assert np.array_equal(a.pool_a, b.pool_a)
    assert np.array_equal(a.pool_c, b.pool_c)
    for _ in range(3):
        next(a)
    assert not np.array_equal(next(a)["tokens"], next(b)["tokens"])


@pytest.mark.parametrize("arch", [ARCH, "qwen2-vl-72b"])
def test_make_loader_matches_the_reference(arch):
    """The loader's batches on the CPU equal the reference's (positions
    for M-RoPE), and ``skip`` replays the stream from a later step."""
    from repro.configs.base import ShapeConfig as JShape
    cfg = tconfigs.get_smoke(arch)
    ref = jpipe.make_loader(jconfigs.get_smoke(arch), JShape("s", 12, 2,
                                                             "train"),
                            seed=4, start_step=1)
    port = tpipe.make_loader(cfg, ShapeConfig("s", 12, 2, "train"), seed=4,
                             start_step=1, device="cpu")
    want = [next(ref) for _ in range(3)]
    for w in want:
        got = next(port)
        assert sorted(got) == sorted(w)
        for k in got:
            assert got[k].device.type == "cpu"
            assert np.array_equal(got[k].numpy(), np.asarray(w[k]))
    later = tpipe.make_loader(cfg, ShapeConfig("s", 12, 2, "train"), seed=4,
                              start_step=1, device="cpu", skip=2)
    assert np.array_equal(next(later)["tokens"].numpy(),
                          np.asarray(want[2]["tokens"]))


def test_loader_depth_order_and_counts():
    """``depth`` batches in flight at most, every batch in order, then
    StopIteration; on the CPU every copy has landed when asked for."""
    batches = [{"tokens": np.full((2, 3), i, np.int32),
                "labels": np.full((2, 3), -i, np.int32)} for i in range(7)]
    loader = tpipe.PrefetchingLoader(iter(batches), depth=3, device="cpu")
    seen = []
    for b in loader:
        assert len(loader._queue) <= 3
        assert loader.amu.outstanding <= 2 * 3
        seen.append(int(b["tokens"][0, 0]))
        assert torch.equal(b["labels"], -b["tokens"])
    assert seen == list(range(7))
    with pytest.raises(StopIteration):
        next(loader)
    assert loader.counts() == {"aloads": 14, "landed": 14, "waited": 0}


def test_device_transfer_backend_on_the_cpu():
    """Copies, never views, of the source; done at once: getfin returns
    the id at the first poll.  A store to pinned host is refused."""
    amu = AMU(backend=DeviceTransferBackend("cpu"), max_outstanding=4)
    src = np.arange(6, dtype=np.float32)
    rid = amu.aload(src)
    assert amu.request(rid).state is RequestState.DONE
    assert amu.getfin() == rid and amu.getfin() == FAILURE_CODE
    out = amu.result(rid)
    src[0] = 100.0
    assert isinstance(out, torch.Tensor) and out[0] == 0.0
    t = torch.ones(3)
    tid = amu.aload(t)
    t.add_(1.0)
    assert torch.equal(amu.result(amu.wait(tid).rid), torch.ones(3))
    sid = amu.astore(torch.ones(3))
    assert amu.request(sid).state is RequestState.FAILED
    with pytest.raises(AMUError, match="failed"):
        amu.getfin()
    assert amu.stats["aload"] == 2 and amu.stats["astore"] == 1


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_fault_tolerance_copies_give_the_reference_results():
    durations = [1.0, 1.1, 0.9, 1.0, 1.05, 3.5, 1.0, 0.95, 2.9, 1.0]
    reps = []
    for mod in (jft, tft):
        det = mod.StragglerDetector(threshold=2.5, window=4, min_samples=3)
        found = [det.record(d) for d in durations]
        reps.append(([dataclasses.asdict(r) for r in found if r],
                     det.straggler_fraction))
    assert reps[0] == reps[1] and len(reps[0][0]) == 2

    beats = []
    for mod in (jft, tft):
        now = [0.0]
        hb = mod.Heartbeat(timeout_s=5.0, clock=lambda: now[0])
        hb.beat()
        now[0] = 4.0
        a = hb.stalled()
        now[0] = 9.5
        beats.append((a, hb.stalled(), hb.beats))
    assert beats[0] == beats[1] == (False, True, 1)

    for shape, axes, left in (((4, 2), ("data", "model"), 6),
                              ((2, 2, 2), ("pod", "data", "model"), 5),
                              ((8, 1), ("data", "model"), 3)):
        assert dataclasses.asdict(tft.elastic_plan(shape, axes, left)) == \
            dataclasses.asdict(jft.elastic_plan(shape, axes, left))
    for mod in (jft, tft):
        with pytest.raises(ValueError):
            mod.elastic_plan((2, 4), ("data", "model"), 3)

    results = []
    for mod in (jft, tft):
        calls, failures = [], []

        def step(state):
            calls.append(state)
            if len(calls) < 3:
                raise mod.StepFailure("boom")
            return state + 1

        out = mod.run_with_retries(
            step, 10, restore_fn=lambda: 5,
            on_failure=lambda e, n: failures.append(n))
        results.append((out, calls, failures))
        with pytest.raises(mod.StepFailure):
            mod.run_with_retries(lambda s: (_ for _ in ()).throw(
                mod.StepFailure("x")), 0, restore_fn=lambda: 0,
                max_retries=1)
    assert results[0] == results[1] == (6, [10, 5, 5], [1, 2])


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

CLI = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "32",
       "--log-every", "100"]


def test_cli_losses_match_the_reference(tmp_path):
    """Both CLIs resume one checkpoint of the JAX init and train 6 steps
    (bf16 compute); the reference then reads the port's last
    checkpoint."""
    cfg = jconfigs.get_smoke(ARCH)
    jp = jax.jit(jmodel.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    jopt = jadamw.adamw_init(jp)
    jckpt.save(tmp_path / "init", 0, (jp, jopt), metadata={"step": 0})
    for tag in ("j", "t"):
        shutil.copytree(tmp_path / "init", tmp_path / tag)
    args = CLI + ["--steps", "6", "--resume"]
    want = jtrain.main(args + ["--ckpt-dir", str(tmp_path / "j")])
    got = ttrain.main(args + ["--ckpt-dir", str(tmp_path / "t"),
                              "--device", "cpu"])
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=0, atol=CLI_TOL)
    assert tckpt.all_steps(tmp_path / "t") == [0, 6]
    (jrp, jro), meta = jckpt.restore(tmp_path / "t", target=(jp, jopt))
    assert meta["step"] == 6 and int(jro.step) == 6
    assert meta["loss"] == got[-1]


def test_cli_recovery_repeats_the_uninterrupted_run(tmp_path):
    """8 steps, then 8 with a checkpoint at 4 and a failure at 6: the
    recovered run restores step 4 and trains steps 4-7 on the batches
    they had, bitwise the uninterrupted run's losses on the CPU."""
    plain = ttrain.main(CLI + ["--steps", "8", "--device", "cpu"])
    out = ttrain.run(ttrain.parse(
        CLI + ["--steps", "8", "--device", "cpu", "--ckpt-dir",
               str(tmp_path), "--ckpt-every", "4", "--fail-at-step", "6"]))
    assert out["losses"] == plain[:6] + plain[4:]
    assert out["steps"] == 8 and int(out["opt"].step) == 8
    assert tckpt.all_steps(tmp_path) == [4, 8]
    # two arrays a batch; a loader issues the batches it hands out and
    # keeps 2 more in flight: 7 + 2 before the failure, 4 + 2 after
    assert out["loader"]["aloads"] == 2 * ((7 + 2) + (4 + 2))


def test_cli_resume_across_processes(tmp_path):
    """A second run with ``--resume`` starts at the saved step and
    continues to ``--steps``."""
    ttrain.main(CLI + ["--steps", "3", "--device", "cpu", "--ckpt-dir",
                       str(tmp_path)])
    out = ttrain.run(ttrain.parse(CLI + ["--steps", "5", "--device", "cpu",
                                         "--ckpt-dir", str(tmp_path),
                                         "--resume"]))
    assert len(out["losses"]) == 2 and int(out["opt"].step) == 5
    assert tckpt.latest_step(tmp_path) == 5


def test_cli_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="queue 1, item 2"):
        ttrain.main(CLI + ["--steps", "1", "--device", "cpu",
                           "--data-axis", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        ttrain.main(CLI + ["--steps", "1"])
    with pytest.raises(NotImplementedError, match="queue 1, item 1"):
        ttrain.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps", "1",
                     "--device", "cpu"])


def test_train_lm_example(monkeypatch):
    """The example's path at a narrow width: the config registered for
    the run only, the loss falling."""
    tiny = dataclasses.replace(
        train_lm.config(), num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
    monkeypatch.setattr(train_lm, "config", lambda: tiny)
    ids = list(tconfigs.ARCH_IDS)
    losses = train_lm.main(["--steps", "40", "--device", "cpu"])
    assert len(losses) == 40 and losses[-1] < losses[0]
    assert tiny.name not in tconfigs._ARCH_MODULES
    assert tconfigs.ARCH_IDS == ids
