"""The whole-prompt dense prefill and the non-paged engine of the port
against the JAX package, on the CPU.

The dense prefill's sequence scatter into pool frames (bf16, and the
int8 / fp8 pool's quantize-and-scatter) against the JAX functions; the
dense cache's slot moves; the engine admitting through the dense
prefill (``chunk_tokens`` unset, a prompt longer than an SWA ring) and
with paging off, token-exact with the JAX engine on bridged f32 weights
(``compute_dtype="float32"``), on pools where both preempt; the
``serve_engine`` example's counts against the JAX example's; and CPU
rehearsals of ``chip_smoke.py`` phases 8 and 8w at the smoke width with
full-width page bytes (scheduling reads shapes and page bytes only).
"""

import contextlib
import dataclasses
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jax_init_params
from repro.paging import PagingError as JaxPagingError
from repro.serve import config as jconf
from repro.serve import transfer as jtransfer
from repro.serve.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.kv_quant import KVQuantConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import serve_engine
from repro_torch.models.model import init_cache, init_params
from repro_torch.paging import Pager, PagingError
from repro_torch.serve import config as tconf
from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import extract_slot, insert_slot
from repro_torch.serve.transfer import (_scatter_seq_pages,
                                        _scatter_seq_pages_q)

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("preemptions", "resumes", "prefill_preempts", "chunks",
            "mixed_steps", "steps", "admitted", "prefills")


# ---------------------------------------------------------------------------
# the sequence scatter and the slot moves
# ---------------------------------------------------------------------------

L, N, PAGE, HKV, D = 2, 9, 4, 2, 16
FRAMES = np.array([5, 2, 7, 0], np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests run small tensors, and the test
    runner's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single(seed, S=14):
    """A prefill's (L, 1, S, Hkv, D) bf16 K or V: S = 14 leaves the last
    of the 4 pages half padded."""
    x = np.random.default_rng(seed).standard_normal((L, 1, S, HKV, D))
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[t.dtype])


def test_scatter_seq_pages_matches_jax():
    ks, vs = _single(0), _single(1)
    kp = torch.full((L, N, PAGE, HKV, D), 3.0, dtype=torch.bfloat16)
    vp = kp.clone()
    jk, jv = jtransfer._scatter_seq_pages(
        _jnp(kp), _jnp(vp), _jnp(ks), _jnp(vs), jnp.asarray(FRAMES),
        len(FRAMES))
    _scatter_seq_pages(kp, vp, ks, vs, torch.from_numpy(FRAMES).long(),
                       len(FRAMES))
    np.testing.assert_array_equal(kp.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(vp.float().numpy(),
                                  np.asarray(jv, np.float32))
    assert bool((kp[:, 1] == 3.0).all())             # unmapped frame kept


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_scatter_seq_pages_q_matches_jax(mode):
    """Bytes equal, scales within 1e-7: one absmax scale per (layer,
    frame, KV head) of each written frame, the pad rows zero."""
    qcfg = KVQuantConfig(mode)
    ks, vs = _single(2), _single(3)
    kp = torch.zeros((L, N, PAGE, HKV, D), dtype=qcfg.dtype)
    vp = torch.zeros_like(kp)
    ksc = torch.full((L, N, HKV), 0.5)
    vsc = ksc.clone()
    jdt = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[mode]
    jk, jv, jks, jvs = jtransfer._scatter_seq_pages_q(
        jnp.zeros(kp.shape, jdt), jnp.zeros(kp.shape, jdt),
        jnp.asarray(ksc.numpy()), jnp.asarray(vsc.numpy()), _jnp(ks),
        _jnp(vs), jnp.asarray(FRAMES), len(FRAMES), mode)
    _scatter_seq_pages_q(kp, vp, ksc, vsc, ks, vs,
                         torch.from_numpy(FRAMES).long(), len(FRAMES), mode)
    for got, ref in ((kp, jk), (vp, jv)):
        np.testing.assert_array_equal(
            got.view(torch.uint8).numpy(),
            np.asarray(ref).view(np.uint8))
    for got, ref in ((ksc, jks), (vsc, jvs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-7,
                                   rtol=0)
    assert bool((ksc[:, 1] == 0.5).all())            # unmapped frame kept


def test_insert_and_extract_slot_move_one_row():
    cfg = get_smoke("mistral-nemo-12b")
    cache = init_cache(cfg, 3, 32, device="cpu")
    single = init_cache(cfg, 1, 32, device="cpu")
    k = torch.randn((cfg.num_layers, 1, 20, cfg.num_kv_heads, cfg.head_dim))
    single = single._replace(kv=dict(single.kv, k=k.bfloat16(),
                                     v=(2 * k).bfloat16()),
                             pos=torch.tensor([20], dtype=torch.int32))
    out = insert_slot(cache, single, 1, 3)
    assert out is cache
    assert torch.equal(cache.kv["k"][:, 1:2, :20], k.bfloat16())
    assert not cache.kv["k"][:, 1, 20:].any() and not cache.kv["k"][:, 0].any()
    assert cache.pos.tolist() == [0, 20, 0]
    row = extract_slot(cache, 1, 3)
    assert tuple(row.kv["k"].shape) == (cfg.num_layers, 1, 32,
                                        cfg.num_kv_heads, cfg.head_dim)
    assert torch.equal(row.kv["v"][:, :, :20], (2 * k).bfloat16())
    assert row.pos.tolist() == [20] and int(row.kv["slots"]) == 32


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

_WEIGHTS = {}


def weights(arch):
    if arch not in _WEIGHTS:
        jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                                   compute_dtype="float32")
        tcfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _WEIGHTS[arch] = (jcfg, tcfg, jp, tp)
    return _WEIGHTS[arch]


def _econf(mod, pages, chunk, enabled=None, kv_quant="none", **extra):
    return mod.EngineConfig(
        max_batch=3, max_len=32, prefill_buckets=(8, 16, 32),
        paging=mod.PagingConfig(enabled=enabled, page_size=4,
                                device_pages=pages, hot_tail_pages=1,
                                kv_quant=kv_quant),
        chunking=mod.ChunkingConfig(chunk_tokens=chunk, chunk_slots=2),
        **extra)


#: id -> (arch, prompt lengths, new tokens, pages, chunk_tokens, paging,
#: pool): every paged case preempts in the reference; danube's prompts
#: of 12, 20 and 15 tokens outgrow its 8-token ring and take the dense
#: prefill, the others the chunk queue, and decode wraps the ring
CASES = {
    "nemo-dense-prefill": ("mistral-nemo-12b", [13, 6, 17, 9, 20, 5], 10, 8,
                           None, None, "none"),
    "olmoe-dense-prefill": ("olmoe-1b-7b", [13, 6, 17, 9, 20, 5], 7, 8,
                            None, None, "none"),
    "nemo-non-paged": ("mistral-nemo-12b", [13, 6, 17, 9, 20, 5], 10, None,
                       None, False, "none"),
    "nemo-int8-dense-prefill": ("mistral-nemo-12b", [13, 6, 17, 9, 20, 5],
                                10, 8, None, None, "int8"),
    "danube-both-paths": ("h2o-danube-1.8b", [3, 12, 2, 20, 4, 15, 3], 9, 5,
                          4, None, "none"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_engine(case):
    arch, lens, new, pages, chunk, enabled, quant = CASES[case]
    jcfg, tcfg, jp, tp = weights(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in lens]
    outs = []
    for cls, cfg, params, conf in (
            (JaxEngine, jcfg, jp, _econf(jconf, pages, chunk, enabled,
                                         quant)),
            (Engine, tcfg, tp, _econf(tconf, pages, chunk, enabled, quant,
                                      device="cpu"))):
        eng = cls(cfg, params, conf)
        for p in prompts:
            eng.submit(p, max_new_tokens=new)
        outs.append((eng, eng.run()))
    (jeng, jout), (teng, tout) = outs
    assert tout == jout
    assert {k: teng.stats[k] for k in COUNTERS} == \
        {k: jeng.stats[k] for k in COUNTERS}
    long = sum(len(p) > teng.slot_tokens for p in prompts) if chunk \
        else len(prompts)
    assert teng.stats["prefills"] == long > 0
    if enabled is False:
        assert teng.pager is None and teng.page_pool is None
        assert tuple(teng.cache.kv["k"].shape[1:3]) == (3, 32)
    else:
        assert teng.stats["preemptions"] > 0 and teng.stats["resumes"] > 0
        assert teng.cache.kv["k_pages"].dtype == (
            torch.int8 if quant == "int8" else torch.bfloat16)


def test_submit_takes_prompts_up_to_max_len():
    """A prompt longer than an SWA ring is served (the dense prefill); one
    longer than ``max_len`` outgrows the largest bucket, here as in the
    reference, and is refused at submit."""
    cfg = get_smoke("h2o-danube-1.8b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, params, _econf(tconf, None, 4, device="cpu"))
    rid = eng.submit(np.arange(20) % cfg.vocab_size, max_new_tokens=3)
    with pytest.raises(NotImplementedError, match="max_len"):
        eng.submit(np.zeros(33, np.int32))
    out = eng.run()
    assert len(out[rid]) == 3 and eng.stats["prefills"] == 1


def test_speculation_requires_the_paged_engine():
    for mod, cfg, err in ((jconf, jconfigs.get_smoke("mistral-nemo-12b"),
                           JaxPagingError),
                          (tconf, get_smoke("mistral-nemo-12b"),
                           PagingError)):
        econf = _econf(mod, None, 8, enabled=False,
                       speculation=mod.SpeculationConfig(speculate_k=2),
                       **({"device": "cpu"} if mod is tconf else {}))
        with pytest.raises(err, match="paged engine"):
            (JaxEngine if mod is jconf else Engine)(
                cfg, jax_init_params(cfg, jax.random.PRNGKey(0))
                if mod is jconf else {}, econf)


# ---------------------------------------------------------------------------
# the example and the CLI
# ---------------------------------------------------------------------------

def _example_counts(text: str) -> dict:
    """The counts the serve_engine example prints."""
    pats = {"requests": r"\] (\d+) requests ->", "tokens": r"-> (\d+) tokens",
            "steps": r"tokens in (\d+) decode steps",
            "chunks": r"prefill: (\d+) chunks", "mixed_steps": r"over (\d+) "
            "mixed", "prefills": r"\((\d+) dense fallbacks",
            "preemptions": r"preemptions (\d+)", "resumes": r"resumes (\d+)"}
    return {k: int(re.search(p, text).group(1)) for k, p in pats.items()}


def test_serve_engine_example_counts_match_the_jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_engine_example", ROOT / "examples" / "serve_engine.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        example.main()
    ref = _example_counts(buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = serve_engine.main(["--device", "cpu"])
    assert got == ref == _example_counts(buf.getvalue())
    assert got["preemptions"] > 0 and got["requests"] == 10


def test_serve_cli_dense_prefill_and_new_archs(capsys):
    out = serve_cli.main([
        "--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu",
        "--requests", "3", "--max-new", "4", "--max-len", "64",
        "--page-size", "4", "--chunk-tokens", "0",
        "--prefill-buckets", "8,16"])
    assert len(out) == 3 and all(len(v) == 4 for v in out.values())
    text = capsys.readouterr().out
    assert "dense prefills 3 (buckets (8, 16))" in text
    out = serve_cli.main(["--arch", "seamless-m4t-medium", "--smoke",
                          "--device", "cpu", "--requests", "3",
                          "--max-new", "4"])
    assert len(out) == 3 and all(len(v) == 4 for v in out.values())
    assert "cross state" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# rehearsals of chip_smoke.py phases 8 and 8w
# ---------------------------------------------------------------------------

def _full_page_pager(arch, page):
    full = get_config(arch)
    nbytes = 2 * full.num_layers * page * full.num_kv_heads * \
        full.head_dim * 2                                   # bf16 K + V

    def factory(pool, table, *, page_nbytes):
        return Pager(pool, table, page_nbytes=nbytes)
    return factory, nbytes


def _rehearse(arch, econf, ps, **cfg_change):
    import chip_smoke
    cfg = dataclasses.replace(get_smoke(arch), num_layers=1,
                              compute_dtype="float32", **cfg_change)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = Engine(cfg, params, econf)
    for p in ps:
        eng.submit(p, max_new_tokens=chip_smoke.NEW_TOKENS)
    out = eng.run()
    assert len(out) == len(ps)
    assert all(len(v) == chip_smoke.NEW_TOKENS for v in out.values())
    return eng


def test_chip_smoke_phase8_settings():
    """mistral-nemo-12b's frames (2,621,440 bytes) on phase 3's pool of
    448: the chunk queue preempts and resumes; (a) and (b) admit all 12
    prompts through the dense prefill."""
    import chip_smoke
    factory, nbytes = _full_page_pager(chip_smoke.NEMO_ARCH,
                                       chip_smoke.ENGINE["page_size"])
    assert nbytes == 2_621_440
    ps = chip_smoke.prompts(get_smoke(chip_smoke.NEMO_ARCH).vocab_size)
    eng = _rehearse(chip_smoke.NEMO_ARCH, chip_smoke.engine_config(
        "cpu", chip_smoke.ENGINE["device_pages"], pager_factory=factory), ps)
    assert eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0
    for paging in (True, False):
        eng = _rehearse(chip_smoke.NEMO_ARCH, chip_smoke.dense_config(
            "cpu", paging=paging, pager_factory=factory), ps)
        assert eng.stats["prefills"] == chip_smoke.N_REQUESTS
        assert eng.stats["chunks"] == 0 and eng.paging == paging


def test_chip_smoke_phase8w_settings():
    """h2o-danube-1.8b's 4096-token ring and frames (983,040 bytes) on
    896 frames: the three prompts past the ring take the dense prefill,
    the 4080-token one wraps the ring in decode, and the pool preempts
    and resumes."""
    import chip_smoke
    factory, nbytes = _full_page_pager(chip_smoke.DANUBE_ARCH,
                                       chip_smoke.DANUBE_ENGINE["page_size"])
    assert nbytes == 983_040
    window = get_config(chip_smoke.DANUBE_ARCH).window
    ps = chip_smoke.danube_prompts(get_smoke(chip_smoke.DANUBE_ARCH)
                                   .vocab_size)
    lens = sorted(len(p) for p in ps)
    assert lens[-4] == chip_smoke.DANUBE_WRAP and lens[-3] > window
    eng = _rehearse(chip_smoke.DANUBE_ARCH, chip_smoke.danube_config(
        "cpu", chip_smoke.DANUBE_ENGINE["device_pages"],
        pager_factory=factory), ps, window=window)
    assert eng.slot_tokens == window and eng.pages_per_seq == 256
    assert eng.stats["prefills"] == 3
    assert eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0
