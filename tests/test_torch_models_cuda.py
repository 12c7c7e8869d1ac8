"""The LM tower's serving path on the card: at ``reduced_config("qwen3-8b")``
in f32 the card's logits and caches equal the CPU's within 1e-5 (full f32
products: TF32 and cuBLAS's reduced-precision bf16 reductions off), and in
bf16 decode agrees with teacher-forced within the bound ``chip_smoke.py``
phase 8 holds the full-size model to. Run on the H100 with

    python -m pytest -q -m cuda tests/test_torch_models_cuda.py

Without a card every test here skips (the ``card`` fixture decides).
"""
import dataclasses

import pytest
import torch

from chip_smoke import DECODE_GAP_FACTOR
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.serve import make_decode_step, make_prefill_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(dev, dtype="float32"):
    cfg = dataclasses.replace(reduced_config("qwen3-8b"), param_dtype=dtype,
                              compute_dtype=dtype)
    api = build_model(cfg)
    params = api.init_params(0, cfg, dev)
    return cfg, api, params


def _to(params, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in params.items()}


def test_card_equals_the_cpu(card):
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    cfg, api, params = _model(card)
    cpu = torch.device("cpu")
    cpu_params = _to(params, cpu)
    tokens = torch.randint(0, cfg.vocab_size, (2, 80),
                           generator=torch.Generator().manual_seed(1))
    got = make_prefill_step(cfg)(params, {"tokens": tokens.to(card)})
    want = make_prefill_step(cfg)(cpu_params, {"tokens": tokens})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    step = make_decode_step(cfg)
    cache = api.init_cache(cfg, 2, 12, card)
    cpu_cache = api.init_cache(cfg, 2, 12, cpu)
    for t in range(10):
        tok, logits, cache = step(params, cache, tokens[:, t].to(card))
        want_tok, want_logits, cpu_cache = step(cpu_params, cpu_cache,
                                                tokens[:, t])
        torch.testing.assert_close(logits.cpu(), want_logits, rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(tok.cpu(), want_tok)
        for key in ("k", "v"):
            torch.testing.assert_close(cache[key].cpu(), cpu_cache[key],
                                       rtol=1e-5, atol=1e-5)


def test_bf16_decode_matches_teacher_forced(card):
    """bf16 decode against the bf16 prefill within DECODE_GAP_FACTOR times
    the bf16 prefill's largest gap to the same weights in f32."""
    cfg, api, params = _model(card, "bfloat16")
    tokens = torch.randint(0, cfg.vocab_size, (2, 10),
                           generator=torch.Generator().manual_seed(2)
                           ).to(card)
    tf = make_prefill_step(cfg)(params, {"tokens": tokens}).float()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = {k: ({n: t.float() for n, t in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    exact = make_prefill_step(cfg32)(params32, {"tokens": tokens})
    bound = DECODE_GAP_FACTOR * float((tf - exact).abs().max())
    step = make_decode_step(cfg)
    cache = api.init_cache(cfg, 2, 12, card)
    for t in range(10):
        _, logits, cache = step(params, cache, tokens[:, t])
        gap = float((logits - tf[:, t, :cfg.vocab_size]).abs().max())
        assert gap <= bound, (t, gap, bound)
