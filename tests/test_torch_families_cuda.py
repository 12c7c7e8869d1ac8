"""The LM tower's other families on the card: at ``reduced_config`` of
qwen2-moe-a2.7b, xlstm-1.3b, whisper-tiny and jamba-1.5-large-398b, in f32
the card's prefill logits, decode logits and caches equal the CPU's within
1e-5 (full f32 products: TF32 and cuBLAS's reduced-precision bf16
reductions off), each ssm block within 1e-5 too, and in bf16 decode agrees
with teacher-forced within the bound ``chip_smoke.py`` phases 8 and 9 hold
the full-size models to. The moe models run at ``capacity_factor = E /
k``, where no token drops. The xLSTM model is held within 1e-3 (the
reference's decode-vs-teacher-forced bound), not 1e-5: its blocks agree
within 2e-6 (measured on the H100), and its exponential gates carry that
through eight layers to 3.4e-4 at the logits. Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_families_cuda.py

Without a card every test here skips (the ``card`` fixture decides).
"""
import dataclasses

import pytest
import torch

from chip_smoke import DECODE_GAP_FACTOR
from repro_torch.configs import reduced_config
from repro_torch.models import build_model, encdec, ssm
from repro_torch.serve import make_decode_step, make_prefill_step

pytestmark = pytest.mark.cuda

ARCHS = ["qwen2-moe-a2.7b", "xlstm-1.3b", "whisper-tiny",
         "jamba-1.5-large-398b"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cfg(arch, dtype="float32"):
    cfg = reduced_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


def _batch(cfg, s, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, s),
                                     generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.n_frames, cfg.d_model),
                                      generator=gen)
    return _to(batch, dev)


def _cache(cfg, api, params, batch, dev):
    cache = api.init_cache(cfg, 2, 12, dev)
    if cfg.family == "encdec":
        cache = encdec.encode_prefill(params, cfg, batch["frames"], cache)
    return cache


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# the model-level tolerance of ``test_card_equals_the_cpu`` (docstring)
TOL = {"xlstm-1.3b": 1e-3}


@pytest.mark.parametrize("block,arch", [
    ("mlstm", "xlstm-1.3b"), ("slstm", "xlstm-1.3b"),
    ("mamba", "jamba-1.5-large-398b")])
def test_ssm_blocks_card_equal_the_cpu(card, block, arch):
    """One ssm block in f32, its train form over 16 tokens and 16 decode
    steps (with the state after them), card against CPU within 1e-5."""
    cfg = _cfg(arch)
    p = getattr(ssm, f"init_{block}")(
        torch.Generator(card).manual_seed(3), cfg)
    cpu = torch.device("cpu")
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(4)) * 0.5
    for dev in (card, cpu):
        q = _to(p, dev)
        train = getattr(ssm, f"{block}_train")(q, cfg, x.to(dev))
        cache = getattr(ssm, f"{block}_cache")(cfg, 2, dev)
        outs = []
        for t in range(16):
            o, cache = getattr(ssm, f"{block}_decode")(
                q, cfg, x[:, t:t + 1].to(dev), cache)
            outs.append(o)
        got = [train.cpu(), torch.cat(outs, 1).cpu(),
               *[v.cpu() for _, v in sorted(cache.items())]]
        if dev == card:
            on_card = got
    for a, b in zip(on_card, got):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_card_equals_the_cpu(card, arch):
    tol = TOL.get(arch, 1e-5)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    cfg = _cfg(arch)
    api = build_model(cfg)
    cpu = torch.device("cpu")
    params = api.init_params(0, cfg, card)
    cpu_params = _to(params, cpu)
    batch = _batch(cfg, 16, card, 1)
    cpu_batch = _to(batch, cpu)
    got = make_prefill_step(cfg)(params, batch)
    want = make_prefill_step(cfg)(cpu_params, cpu_batch)
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    step = make_decode_step(cfg)
    cache = _cache(cfg, api, params, batch, card)
    cpu_cache = _cache(cfg, api, cpu_params, cpu_batch, cpu)
    for t in range(10):
        tok, logits, cache = step(params, cache, batch["tokens"][:, t])
        want_tok, want_logits, cpu_cache = step(cpu_params, cpu_cache,
                                                cpu_batch["tokens"][:, t])
        torch.testing.assert_close(logits.cpu(), want_logits, rtol=tol,
                                   atol=tol)
        assert torch.equal(tok.cpu(), want_tok)
    want = dict(_leaves(cpu_cache))
    for name, v in _leaves(cache):
        torch.testing.assert_close(v.cpu(), want[name], rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_matches_teacher_forced(card, arch):
    """bf16 decode against the bf16 prefill within DECODE_GAP_FACTOR times
    the bf16 prefill's largest gap to the same weights in f32."""
    cfg = _cfg(arch, "bfloat16")
    api = build_model(cfg)
    params = api.init_params(0, cfg, card)
    batch = _batch(cfg, 10, card, 2)
    tf = make_prefill_step(cfg)(params, batch).float()
    exact = make_prefill_step(_cfg(arch))(_to_f32(params), batch)
    bound = DECODE_GAP_FACTOR * float((tf - exact).abs().max())
    step = make_decode_step(cfg)
    cache = _cache(cfg, api, params, batch, card)
    for t in range(10):
        _, logits, cache = step(params, cache, batch["tokens"][:, t])
        gap = float((logits - tf[:, t, :cfg.vocab_size]).abs().max())
        assert gap <= bound, (t, gap, bound)


def _to_f32(tree):
    return {k: (_to_f32(v) if isinstance(v, dict) else v.float())
            for k, v in tree.items()}
