"""The training path's device pieces on the card (marked ``cuda``; they
skip where no CUDA device is present, as on a CPU-only machine).

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_train_cuda.py

``DeviceTransferBackend``'s copies land on the device bit for bit, a
poll finds each done after its event and ``wait`` blocks until then;
the loader's batches equal the stream's; one f32 train step on the card
agrees with the CPU's (f32 products without TF32: hidden states within
1e-4 of their largest magnitude, loss 1e-4, gradient norm 1e-3, the
bars of ``chip_smoke.py`` 13 (c)); a recovered run of the train CLI is
bitwise the uninterrupted one under deterministic algorithms.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.amu import AMU, DeviceTransferBackend, RequestState
from repro_torch.data.pipeline import SyntheticLM, make_loader
from repro_torch.launch import train
from repro_torch.models import model as model_mod
from repro_torch.optim.adamw import adamw_init
from repro_torch.steps import make_train_step
from repro_torch.tree import tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def test_device_transfer_backend_lands_bitwise(dev):
    amu = AMU(backend=DeviceTransferBackend(dev), max_outstanding=8)
    srcs = [np.random.default_rng(i).standard_normal((256, 1024))
            .astype(np.float32) for i in range(6)]
    rids = [amu.aload(x) for x in srcs]
    torch.cuda.synchronize()
    for rid, x in zip(rids, srcs):
        req = amu.wait(rid)
        assert req.state is RequestState.CONSUMED
        out = amu.result(rid)
        assert out.is_cuda and torch.equal(out.cpu(), torch.from_numpy(x))
    assert amu.stats["aload"] == amu.stats["completed"] == 6


def test_loader_on_the_card_gives_the_stream(dev):
    cfg = get_smoke("h2o-danube-1.8b")
    shape = ShapeConfig("s", 64, 4, "train")
    loader = make_loader(cfg, shape, seed=3, device=dev)
    ref = SyntheticLM(cfg.vocab_size, 64, 4, seed=3)
    for _ in range(5):
        got, want = next(loader), next(ref)
        for k in want:
            assert got[k].is_cuda
            assert np.array_equal(got[k].cpu().numpy(), want[k])
    counts = loader.counts()
    assert counts["aloads"] == 2 * (5 + 2)
    assert counts["landed"] + counts["waited"] == 10


def test_train_step_on_the_card_matches_the_cpu(dev):
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"),
                              compute_dtype="float32")
    host = model_mod.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    batch = next(SyntheticLM(cfg.vocab_size, 32, 2, seed=1))
    got = []
    for where in (dev, torch.device("cpu")):
        params = tree_map(lambda p: p.to(where, copy=True), host)
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        with torch.no_grad():
            x = model_mod.forward(params, cfg, b, remat="none")[0].cpu()
        step = make_train_step(cfg, TrainConfig(warmup_steps=1,
                                                total_steps=10))
        _, _, m = step(params, adamw_init(params), b)
        got.append((x, float(m["loss"]), float(m["grad_norm"])))
    (xd, ld, gd), (xc, lc, gc) = got
    assert float((xd - xc).abs().max() / xc.abs().max()) <= 1e-4
    assert abs(ld - lc) <= 1e-4 * abs(lc)
    assert abs(gd - gc) <= 1e-3 * abs(gc)


def test_recovery_on_the_card_is_bitwise(dev, tmp_path):
    args = ["--arch", "h2o-danube-1.8b", "--smoke", "--steps", "8",
            "--batch", "4", "--seq", "64", "--log-every", "100"]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = train.main(args)
        out = train.run(train.parse(args + [
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
            "--fail-at-step", "6"]))
    finally:
        torch.use_deterministic_algorithms(was)
    assert out["losses"] == plain[:6] + plain[4:]
    assert next(iter(out["params"]["embed"].values())).is_cuda
