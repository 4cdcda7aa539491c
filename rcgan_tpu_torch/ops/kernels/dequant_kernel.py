"""CIFAR dequantisation: Triton kernel and plain version.

Replaces the Pallas TPU kernel ``_kernel`` of ``dequantize_chw_flat`` /
``dequantize_fused`` (``rcgan_tpu/ops/pallas/dequant_kernel.py``): uint8
CHW-flat rows → ``2(x/256 − 0.5) + u`` with ``u ~ U[0, 1/128)``, written in
HWC order as float32 ``[B, H*W*C]``.  The noise of a row comes from a
generator seeded by that row's own seed, so a row's output is the same in
any batch it sits in (the TPU kernel's layout invariance; the trainer keys
the seeds by global example index, ``rcgan_tpu_torch/core/rng.py``).

On the H100 this is one elementwise pass over about 1 MB at the training
shape ([64, 3072]: 196 608 bytes in, 786 432 out), far below any bound of
the card; what the design saves is passes and bytes:

- one program per row reads that row's seed and its **uint8** bytes
  directly (the TPU wrapper widened to int32 first, 4x the bytes read);
- the noise is Philox (``tl.randint``) keyed by ``(seed_row, chw offset)``,
  the counter-based generator that takes the place of the TPU's on-core
  PRNG; its top 24 bits scale to ``[0, 1/128)`` exactly as the TPU kernel
  scaled its bits (``(bits >> 8) · 2⁻²⁴ / 128``), so ``u < 1/128`` holds
  strictly;
- the store goes to the HWC index, so the CHW → HWC transpose costs no pass
  of its own.

The plain version takes the noise ``u`` as an argument (drawn by
``torch.rand`` from a generator seeded per row, or handed in by a test),
so it cannot give the kernel's bits; the two agree exactly on the
noise-free part and in distribution on the noise.
"""

from __future__ import annotations

import torch

from rcgan_tpu_torch.ops.kernels import runtime

_BLOCK = 1024  # CHW offsets per step of a row's loop

_kernel = None


def dequantize_plain(x: torch.Tensor, u: torch.Tensor, img_size: int = 32,
                     img_dim: int = 3) -> torch.Tensor:
    """``x [B, C*H*W]`` integer (uint8 values), ``u [B, C*H*W]`` float32
    noise, both CHW order → float32 ``[B, H*W*C]`` in HWC order."""
    out = 2.0 * (x.float() / 256.0 - 0.5) + u
    b = x.shape[0]
    out = out.reshape(b, img_dim, img_size, img_size).permute(0, 2, 3, 1)
    return out.reshape(b, img_size * img_size * img_dim)


def row_noise(seeds: torch.Tensor, dim: int) -> torch.Tensor:
    """``[B, dim]`` float32 noise in ``[0, 1/128)`` for the plain version on
    the CPU: row ``i`` from a CPU ``torch.Generator`` seeded with
    ``seeds[i]``, so each row depends only on its own seed."""
    rows = []
    for s in seeds.tolist():
        gen = torch.Generator().manual_seed(int(s))
        rows.append(torch.rand(dim, generator=gen))
    return torch.stack(rows) / 128.0


def _build():
    """Compile-on-first-use Triton kernel (``triton`` is imported here, never
    at module import; ``tl`` is bound as a module global because Triton
    resolves a kernel's names through its module's globals)."""
    global _kernel, tl
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def dequant(x_ptr, seed_ptr, out_ptr, hw, img_dim, BLOCK: tl.constexpr):
        row = tl.program_id(0)
        seed = tl.load(seed_ptr + row)
        d = hw * img_dim
        base_in = x_ptr + row.to(tl.int64) * d
        base_out = out_ptr + row.to(tl.int64) * d
        for start in range(0, d, BLOCK):
            chw = start + tl.arange(0, BLOCK)
            mask = chw < d
            v = tl.load(base_in + chw, mask=mask, other=0).to(tl.float32)
            bits = tl.randint(seed, chw).to(tl.uint32, bitcast=True)
            u = (bits >> 8).to(tl.float32) * (1.0 / 16777216.0 / 128.0)
            out = 2.0 * (v / 256.0 - 0.5) + u
            c = chw // hw
            hwc = (chw - c * hw) * img_dim + c
            tl.store(base_out + hwc, out, mask=mask)

    _kernel = dequant
    return _kernel


def _check(x: torch.Tensor, seeds: torch.Tensor, img_size: int, img_dim: int) -> None:
    d = img_size * img_size * img_dim
    if x.dim() != 2 or x.shape[1] != d or x.dtype != torch.uint8:
        raise ValueError(f"dequantize wants uint8 x [B, {d}]; got {x.dtype} {tuple(x.shape)}")
    if seeds.shape != (x.shape[0],) or seeds.dtype != torch.int32:
        raise ValueError(f"dequantize wants int32 seeds [{x.shape[0]}]; got {seeds.dtype} "
                         f"{tuple(seeds.shape)}")
    if not (x.is_contiguous() and seeds.is_contiguous()):
        raise ValueError("dequantize wants contiguous x and seeds")


def _launch(x: torch.Tensor, seeds: torch.Tensor, img_size: int, img_dim: int) -> torch.Tensor:
    _check(x, seeds, img_size, img_dim)
    kernel = _build()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        kernel[(x.shape[0],)](x, seeds, out, img_size * img_size, img_dim, BLOCK=_BLOCK,
                              num_warps=4)
    runtime.count_launch("dequant")
    return out


def dequantize(x: torch.Tensor, seeds: torch.Tensor, img_size: int = 32,
               img_dim: int = 3) -> torch.Tensor:
    """uint8 ``x [B, C*H*W]`` (CHW order), int32 per-row ``seeds [B]`` →
    float32 ``[B, H*W*C]`` in ``[-1, 1)``, HWC order.  CUDA tensors launch
    the Triton kernel on the current stream (or raise); CPU tensors take
    :func:`dequantize_plain` with :func:`row_noise`."""
    if runtime.on_cuda(x, seeds):
        return _launch(x, seeds, img_size, img_dim)
    _check(x, seeds, img_size, img_dim)
    return dequantize_plain(x, row_noise(seeds, x.shape[1]), img_size, img_dim)
