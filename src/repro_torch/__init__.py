"""Dynamic GUS in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` (which stays the reference): the same
module layout (``repro_torch/core/gus.py`` mirrors ``repro/core/gus.py``),
plain functions on tensors with an explicit ``device``, and CUDA C++
kernels under ``kernels/csrc`` in place of the Pallas TPU kernels. The
package imports torch, numpy and the standard library only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back to the CPU.

Float32 products stay full float32 on the card: TF32 would keep about
three decimal digits, enough to flip SimHash sign bits
(``core/buckets.py``) and partition or PQ-code argmins. For the same
reason bf16 products keep their f32 accumulation to the end: cuBLAS may
otherwise round split-K partial sums to bf16, where the reference's
products accumulate in f32 (the LM tower, ``models/``). All three
switches are set here, once for the whole package.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
