"""How far the xLSTM model carries f32 rounding, on the card.

    python tools/torch_xlstm_sensitivity.py

Prints one JSON line: (1) at ``reduced_config("xlstm-1.3b")`` in f32, one
mLSTM and one sLSTM block, card against CPU (max abs gap, max |out|);
(2) at the published config in f32 (8 GB), decode against teacher-forced
logits for 2 requests x 64 tokens, every 4th token's gap; (3) the same
model's 3,000-token prompt through the chunkwise mLSTM against the
parallel form, the largest gap in each 250 positions, for the whole model
and for its first mLSTM block alone; (4) one sLSTM block's output moved by
a 1e-6 nudge of its input, the largest change in each 250 positions.
Needs a CUDA card. It imports no JAX.
"""
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import build_model, ssm, xlstm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serve import make_decode_step, make_prefill_step  # noqa: E402


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


def _by_250(gap) -> list:
    return [float(gap[i:i + 250].max()) for i in range(0, gap.shape[0], 250)]


@torch.inference_mode()
def main() -> int:
    if not torch.cuda.is_available():
        print("torch_xlstm_sensitivity: no CUDA device", file=sys.stderr)
        return 1
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    out = {"device": torch.cuda.get_device_name(0)}

    cfg = reduced_config("xlstm-1.3b")
    params = xlstm.init_params(0, cfg, dev)
    on_cpu = _to(params, cpu)
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)) * 0.5
    for name, key in (("mlstm", ("mlstm", 0, 0)), ("slstm", ("slstm", 0))):
        fn = getattr(ssm, f"{name}_train")
        a = fn(L.index(params[key[0]], *key[1:]), cfg, x.to(dev)).cpu()
        b = fn(L.index(on_cpu[key[0]], *key[1:]), cfg, x)
        out[f"reduced_{name}_card_vs_cpu"] = float((a - b).abs().max())
        out[f"reduced_{name}_max_out"] = float(b.abs().max())

    cfg = dataclasses.replace(get_config("xlstm-1.3b"),
                              param_dtype="float32", compute_dtype="float32")
    api = build_model(cfg)
    params = api.init_params(0, cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(3)).to(dev)
    tf = make_prefill_step(cfg)(params, {"tokens": toks})
    cache = api.init_cache(cfg, 2, 64, dev)
    step = make_decode_step(cfg)
    errs = []
    for t in range(64):
        _, logits, cache = step(params, cache, toks[:, t])
        errs.append(float((logits - tf[:, t, :cfg.vocab_size]).abs().max()))
    out["f32_decode_vs_tf_every_4th"] = errs[::4]
    out["f32_max_logit"] = float(tf.abs().max())
    del tf, cache

    long = torch.randint(0, cfg.vocab_size, (1, 3000),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    parallel = dataclasses.replace(cfg, mlstm_chunk=0)
    a = make_prefill_step(cfg)(params, {"tokens": long})
    b = make_prefill_step(parallel)(params, {"tokens": long})
    out["f32_model_chunkwise_vs_parallel_by_250"] = _by_250(
        (a - b).abs().amax(-1)[0])
    del a, b
    x = torch.randn(1, 3000, cfg.d_model, device=dev,
                    generator=torch.Generator(dev).manual_seed(5))
    block = L.index(params["mlstm"], 0, 0)
    a = ssm.mlstm_train(block, cfg, x)
    b = ssm.mlstm_train(block, parallel, x)
    out["f32_block_chunkwise_vs_parallel_by_250"] = _by_250(
        (a - b).abs().amax(-1)[0])
    block = L.index(params["slstm"], 0)
    a = ssm.slstm_train(block, cfg, x)
    b = ssm.slstm_train(block, cfg, x + 1e-6 * torch.randn(
        x.shape, device=dev, generator=torch.Generator(dev).manual_seed(6)))
    out["f32_slstm_nudge_1e-6_by_250"] = _by_250((a - b).abs().amax(-1)[0])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
