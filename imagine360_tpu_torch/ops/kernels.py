"""The hand-written Hopper kernels, their plain PyTorch versions, and the
build that turns `csrc/*.cu` into one shared library.

| wrapper                        | CUDA sources                               | replaces (JAX package)                        |
|--------------------------------|--------------------------------------------|-----------------------------------------------|
| `tiny_attention`               | csrc/tiny_attention.cu, _wide.cu (D > 160) | ops/pallas_attention.py:_tiny_packed_kernel   |
| `mh_flash_attention`           | csrc/mh_flash.cu, _wide.cu (D > 160)       | ops/pallas_attention.py:_mh_flash_kernel      |
| `shared_bias_attention`        | csrc/shared_bias.cu (lse output optional)  | ops/pallas_attention.py:_shared_bias_kernel_t |
| `frame_attention`              | csrc/frame_attention.cu                    | ops/pallas_attention.py:_striped_kernel       |
| `flash_attention_lse`          | csrc/flash_lse.cu                          | ops/pallas_attention.py:_flash_kernel         |
| `flash_bwd_dq`                 | csrc/flash_bwd_dq.cu                       | ops/pallas_attention.py:_flash_bwd_dq_kernel  |
| `flash_bwd_dkv`                | csrc/flash_bwd_dkv.cu                      | ops/pallas_attention.py:_flash_bwd_dkv_kernel |
| `flash_attention_t`            | csrc/flash_t.cu                            | ops/pallas_attention.py:_flash_kernel_t       |
| `shared_bias_attention_folded` | csrc/shared_bias_folded.cu                 | ops/pallas_attention.py:_shared_bias_kernel   |
| `dense_matmul`                 | csrc/dense_matmul.cu                       | ops/pallas_dense.py:_matmul_kernel            |
| `striped_v2_attention`         | csrc/frame_attention_v2.cu                 | scripts/kernel_lab.py:_striped_v2_kernel      |
| `fused_motion_attention`       | csrc/motion_fused.cu                       | scripts/exp_motion_kernels.py:_fused_kernel   |
| `diag_motion_attention`        | csrc/motion_diag.cu                        | scripts/exp_motion_kernels.py:_diag_kernel    |

K1-K4 are the forward kernels of inference. Under grad the long-sequence
sites take K5a (`flash_attention_lse`) or K3 with its lse output forward
and K5b + K5c (`flash_bwd_dq`, `flash_bwd_dkv`) backward
(ops/attention.py). K6a (`flash_attention_t`) and K7 (`dense_matmul`) are
opt-in, behind the `attn_v2` and `pallas_dense` switches of ops/dispatch.py;
K6b (`shared_bias_attention_folded`) has its own entry point and no caller
in the models, as in the JAX package. L1-L3 (`striped_v2_attention`,
`fused_motion_attention`, `diag_motion_attention`) are the lab variants of
K4: no model calls them, ops/motion_lab.py:run_lab holds them against K4 and
times them. Each source file says what bounds its kernel on the H100 and
what the design does about it.

Every wrapper takes float32 or bfloat16. K1, K2, K3, K5a, K6a and K6b run
bfloat16 with a head dim up to 160 on the tensor cores, through the
`mma.sync` body of attn_mma.cuh (K3 with two (batch, head) problems a block
under one staged bias tile up to D = 64, K6b with up to two folded rows
under one float32 or bfloat16 bias tile; K5a, K6a and K6b with their
probabilities split exactly into two bfloat16 parts; K6a on its
sequence-minor tiles as they lie), K4 through its own `mma.sync` tile
(frame_attention.cu: packs of neighbouring locations staged with
`cp.async`, one (location, head) problem a warp, `frame_attention_plan`),
K5b and K5c through the `mma.sync` backward tiles of attn_mma_bwd.cuh (dS,
and P for K5c, split the same way), K7 through its own `mma.sync` GEMM tile
(dense_matmul.cu), and float32 on the CUDA cores (attn_common.cuh,
flash_bwd.cuh, dense_matmul.cu, frame_attention.cu, shared_bias_folded.cu).
K1 and K2 take a head dim D from 1 to 512: above 160 (the VAE's one head of
512) through their wide kernels, in bfloat16 on the wide `mma.sync` tile of
attn_mma_wide.cuh (16 warps on 64 query rows, Q·Kᵀ split over the keys, P·V
over the head dim), in float32 on the CUDA cores (attn_wide.cuh). L1-L3
multiply on the CUDA cores. K3, K4, K5a-c, K6a, K6b and L1-L3 take D up to
160; K7 takes any N, K, M >= 1.
L1-L3 raise for a pack that does not fit a block's shared memory and never
shrink it. For a tensor on the CPU a wrapper runs its plain version (einsum
+ softmax, batch-chunked) and counts one `plain_calls`; for a CUDA tensor
it launches its kernel or raises.
There is no fallback from a CUDA tensor to the plain version. A launch
counts one in the wrapper's `launches`, one under its shape in
`shape_launches`, one in `wide_launches` when it took the wide kernel, one
in `tc_launches` when it took the tensor cores (K1 and K2 in bfloat16 with
D <= 512, the wide ones too; K3, K4, K5a, K5b, K5c, K6a and K6b in bfloat16
with D <= 160; K7 in bfloat16), and one in `lse_launches` when K3 or K6b
also wrote its lse.

The library is compiled on first use with `nvcc -gencode
arch=compute_90a,code=sm_90a` into `imagine360_tpu_torch/_build/` (listed in
.gitignore), bound with ctypes, and launched on PyTorch's current stream.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# no plain version materialises more than this many bytes of f32 logits
LOGITS_BYTES_LIMIT = 128 * 1024 * 1024
MAX_HEAD_DIM = 160      # csrc/attn_common.cuh: the largest head-dim bucket (K1-K4)
WIDE_MAX_HEAD_DIM = 512  # csrc/attn_wide.cuh WIDE_MAX_D, attn_mma_wide.cuh kWideMaxD (K1, K2)
TINY_MAX_SK = 1024      # csrc/tiny_attention.cu K1_MAX_SK
FRAME_MAX_F = 64        # csrc/frame_attention.cu K4_MAX_F
DIAG_MAX_F = 32         # csrc/motion_diag.cu L3_MAX_F: a lane owns one logit of a row
DIAG_MAX_WARPS = 8      # csrc/motion_diag.cu L3_MAX_WARPS
FUSED_Q_ROWS = 16       # csrc/motion_fused.cu L2_BQ: query rows of one logit tile
FUSED_THREADS = 512     # csrc/motion_fused.cu L2_NT
SMEM_LIMIT = 232448     # bytes of shared memory one block may have on sm_90 (227 KB)
FOLDED_T_ROWS = 2       # K6b: folded rows a block takes under one bias tile (bf16: 2 beats 1
                        # at the WarpAttn sites on an H100, scripts/torch_frame_folded_check.py)
SM_SHARED_BYTES = 233472  # shared memory of one SM on sm_90 (228 KB), 1 KB of it per block
FRAME_STAGE_BYTES = 40 * 1024  # K4 bf16: most bytes of q, k and v tiles in one of a block's
                               # two stages: two or three blocks an SM (at the motion sites
                               # three, which csrc/frame_attention.cu's launch bounds assume)
FRAME_WAVES = 4         # K4 bf16: blocks a resident block slot takes in turn (sets R)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"   # the CUDA toolkit's default prefix


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def find_nvcc() -> str:
    """Path of nvcc: on PATH, under $CUDA_HOME, or the toolkit's default
    install prefix. Raises when there is none."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the attention kernels cannot be built")


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library (once per source digest)
    and return its path. The sources compile in parallel, one nvcc process
    each, then link. The compiler's register/shared-memory report is kept
    beside the library as `<lib>.ptxas.txt`."""
    lib = BUILD_DIR / f"libi360_attn_{_sources_digest()}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    work = BUILD_DIR / f"{lib.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj, log = work / f"{src.stem}.o", work / f"{src.stem}.log"
            with open(log, "w") as f:
                jobs.append((src, obj, log, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=f, stderr=subprocess.STDOUT, start_new_session=True)))
        for src, _, log, proc in jobs:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n"
                                   f"{log.read_text()[-8000:]}")
    finally:
        for *_, proc in jobs:      # on failure: stop nvcc and its cicc/ptxas
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    tmp = work / lib.name
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *(str(j[1]) for j in jobs)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-8000:]}")
    lib.with_suffix(".ptxas.txt").write_text("".join(j[2].read_text() for j in jobs))
    os.replace(tmp, lib)
    shutil.rmtree(work)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    sigs = {
        "i360_tiny_attention": [P, P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_mh_flash_attention": [P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_tiny_attention_wide": [P, P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_mh_flash_attention_wide": [P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_shared_bias_attention": [P, P, P, P, P, P, I, I, I, I, I, F, I, P],
        "i360_frame_attention": [P, P, P, P, I, I, I, I, I, F, I, I, I, I, P],
        "i360_flash_attention_lse": [P, P, P, P, P, P, I, I, I, I, I, L, L, F, I, P],
        "i360_flash_bwd_dq": [P, P, P, P, P, P, P, P, I, I, I, I, I, L, L, F, I, P],
        "i360_flash_bwd_dkv": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, L, L, F, I, P],
        "i360_flash_attention_t": [P, P, P, P, P, I, I, I, I, I, L, L, F, I, P],
        "i360_shared_bias_attention_folded": [P, P, P, P, P, P, I, I, I, I, I, F, I, I, P],
        "i360_dense_matmul": [P, P, P, I, I, I, L, L, I, P],
        "i360_striped_v2_attention": [P, P, P, P, I, I, I, I, I, I, I, I, F, I, P],
        "i360_fused_motion_attention": [P, P, P, P, P, I, I, I, I, I, I, I, F, I, I, I, P],
        "i360_diag_motion_attention": [P, P, P, P, I, I, I, I, I, I, I, I, I, F, I, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """Validate the kernel's inputs; return the dtype code."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: kernel needs CUDA tensors, got {t.device}")
        if t.device != t0.device:
            raise ValueError(f"{name}: tensors on {t.device} and {t0.device}")
        if t.dtype != t0.dtype:
            raise ValueError(f"{name}: mixed dtypes {t.dtype} and {t0.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs contiguous tensors")
    if t0.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {t0.dtype} not supported "
                         "(float32 or bfloat16)")
    return _DTYPE_CODE[t0.dtype]


def _check_bias(name: str, bias: torch.Tensor, q: torch.Tensor, Sq: int, Sk: int):
    if (bias.device != q.device or bias.dtype != torch.float32
            or tuple(bias.shape) != (Sq, Sk) or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 [{Sq}, {Sk}] "
                         f"tensor on {q.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")


def _check_head_dim(name: str, D: int, max_dim: int = MAX_HEAD_DIM):
    if not 1 <= D <= max_dim:
        raise ValueError(f"{name}: head dim {D} outside 1..{max_dim}")


def _launch(wrapper, fn, q: torch.Tensor, *args, shape: tuple, wide: bool = False,
            tc: bool = False, lse: bool = False) -> None:
    """Launch `fn` on q's device and current stream, raise on a launch
    error, and count the launch on `wrapper`: in `launches`, under `shape`
    in `shape_launches`, in `wide_launches` too when `wide`, in
    `tc_launches` too when `tc`, and in `lse_launches` too when `lse`."""
    if q.numel() == 0:
        return          # nothing to compute; a zero-block grid is a launch error
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed with cudaError {err}")
    wrapper.launches += 1
    wrapper.shape_launches[shape] += 1
    wrapper.wide_launches += wide
    wrapper.tc_launches += tc
    wrapper.lse_launches += lse


def _on_tensor_cores(q: torch.Tensor) -> bool:
    """The kernels with a tensor-core path take it for every bfloat16 input
    they accept: K1 and K2 up to head dim 512 (csrc/attn_mma.cuh to 160,
    above it their wide kernels on csrc/attn_mma_wide.cuh), K3, K5a, K5b,
    K5c, K6a and K6b up to 160 (csrc/attn_mma.cuh, csrc/attn_mma_bwd.cuh),
    K4 up to 160 (csrc/frame_attention.cu), K7 (csrc/dense_matmul.cu) at
    every shape; float32 stays on the CUDA cores."""
    return q.dtype == torch.bfloat16


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _batch_chunks(B: int, H: int, Sq: int, Sk: int):
    """(start, end) batch ranges whose [b, H, Sq, Sk] float32 logits stay
    under LOGITS_BYTES_LIMIT."""
    chunk = max(1, LOGITS_BYTES_LIMIT // max(1, H * Sq * Sk * 4))
    return [(s, min(B, s + chunk)) for s in range(0, B, chunk)]


def _logits(q, k, bias, scale, s, e):
    """float32 logits [e - s, H, Sq, Sk] of batch rows s:e."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q[s:e].float() * scale, k[s:e].float())
    if bias is not None:
        logits = logits + (bias if bias.shape[0] == 1 else bias[s:e]).float()
    return logits


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def reference_attention(q, k, v, bias=None, scale=None):
    """softmax(q k^T * scale + bias) v for q [B, Sq, H, D], k/v
    [B, Sk, H, D], bias broadcastable to [B, H, Sq, Sk]. Logits and softmax
    in float32, probabilities cast to v.dtype before PV, output in q.dtype
    (imagine360_tpu/ops/attention.py:_reference_attention). The batch axis
    is chunked so no chunk holds more than LOGITS_BYTES_LIMIT of logits."""
    B, Sq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    outs = []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        probs = torch.softmax(_logits(q, k, bias, scale, s, e), dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v[s:e]).to(q.dtype))
    return _cat(outs)


def reference_attention_vjp(q, k, v, bias, g, scale=None):
    """(dq, dk, dv) of `reference_attention` for the output cotangent g
    [B, Sq, H, D], recomputed from q, k, v in float32, batch-chunked like
    the forward: p = softmax(s), dv = p^T g, dp = g v^T,
    ds = p * (dp - rowsum(p * dp)), dq = ds k * scale, dk = ds^T q * scale.
    The bias is a constant and gets no gradient. This is the backward of
    the sites whose forward kernels (K1, K4) have no backward kernel in the
    JAX package either (its `_kernel_attention_bwd` differentiates the
    einsum reference)."""
    B, Sq, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    dqs, dks, dvs = [], [], []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        p = torch.softmax(_logits(q, k, bias, scale, s, e), dim=-1)
        gf = g[s:e].float()
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, gf).to(v.dtype))
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, v[s:e].float())
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, k[s:e].float()) * scale).to(q.dtype))
        dks.append((torch.einsum("bhqk,bqhd->bkhd", ds, q[s:e].float()) * scale).to(k.dtype))
    return _cat(dqs), _cat(dks), _cat(dvs)


def _softmax_stats(logits):
    """(p, denom, lse) of the streaming kernels for float32 logits: the max
    is floored at the kernels' finite -1e30, a zero denominator becomes 1
    before the divide and the log, lse = m + log(denom)."""
    m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return p, denom, (m + torch.log(denom))[..., 0]


def flash_attention_lse_plain(q, k, v, bias=None, *, scale):
    """Plain K5a: (out [B, Sq, H, D] in q.dtype, lse [B, H, Sq] float32).
    Probabilities stay float32 through the PV product, as in the kernel."""
    B, Sq, H, D = q.shape
    outs, lses = [], []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        p, denom, lse = _softmax_stats(_logits(q, k, bias, scale, s, e))
        out = torch.einsum("bhqk,bkhd->bhqd", p, v[s:e].float()) / denom
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
        lses.append(lse)
    return _cat(outs), _cat(lses)


def _bwd_scores(q, k, v, bias, g, lse, delta, scale, s, e):
    """(p, ds) [e - s, H, Sq, Sk] float32 of the streaming backward:
    p = exp(s - lse), dp = g v^T, ds = p * (dp - delta)."""
    p = torch.exp(_logits(q, k, bias, scale, s, e) - lse[s:e, :, :, None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g[s:e].float(), v[s:e].float())
    return p, p * (dp - delta[s:e, :, :, None])


def flash_bwd_dq_plain(q, k, v, bias, g, lse, delta, *, scale):
    """Plain K5b: dq = (sum_k ds k) * scale, [B, Sq, H, D] in q.dtype."""
    B, Sq, H, D = q.shape
    dqs = []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        _, ds = _bwd_scores(q, k, v, bias, g, lse, delta, scale, s, e)
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, k[s:e].float()) * scale).to(q.dtype))
    return _cat(dqs)


def flash_bwd_dkv_plain(q, k, v, bias, g, lse, delta, *, scale):
    """Plain K5c: dk = (sum_q ds^T q) * scale and dv = sum_q p^T g, both
    [B, Sk, H, D] in the dtypes of k and v."""
    B, Sq, H, D = q.shape
    dks, dvs = [], []
    for s, e in _batch_chunks(B, H, Sq, k.shape[1]):
        p, ds = _bwd_scores(q, k, v, bias, g, lse, delta, scale, s, e)
        dks.append((torch.einsum("bhqk,bqhd->bkhd", ds, q[s:e].float()) * scale).to(k.dtype))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, g[s:e].float()).to(v.dtype))
    return _cat(dks), _cat(dvs)


def flash_attention_t_plain(q, k, v, bias=None, *, scale):
    """Plain K6a: q [B, H, D, Sq], k/v [B, H, D, Sk], bias None or
    [1|B, 1|H, Sq, Sk]; returns [B, H, Sq, D] in q.dtype. Probabilities stay
    float32 through the PV product, as in the kernel."""
    out, _ = flash_attention_lse_plain(q.permute(0, 3, 1, 2), k.permute(0, 3, 1, 2),
                                       v.permute(0, 3, 1, 2), bias, scale=scale)
    return out.permute(0, 2, 1, 3).contiguous()


def shared_bias_attention_folded_plain(q, k, v, bias, *, scale, with_lse=False):
    """Plain K6b: q [BH, Sq, D], k/v [BH, Sk, D], bias [Sq, Sk] of any float
    dtype; returns [BH, Sq, D] in q.dtype and, with `with_lse`, the lse
    [BH, Sq] float32. Probabilities stay float32 through the PV product."""
    out, lse = flash_attention_lse_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                                         bias[None, None], scale=scale)
    return (out[:, :, 0], lse[:, 0]) if with_lse else out[:, :, 0]


def dense_matmul_plain(x, w, *, linear_layout=False):
    """Plain K7: x [N, K] @ w ([K, M], or [M, K] with `linear_layout`) in
    float32, cast to x.dtype."""
    wf = w.float()
    return torch.matmul(x.float(), wf.t() if linear_layout else wf).to(x.dtype)


def attention_delta(g, out):
    """delta = rowsum(g * out) in float32, [B, H, Sq] (stock ops, as the JAX
    package leaves it to XLA)."""
    return (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def tiny_attention_plain(q, k, v, bias=None, *, scale, heads):
    B, Sq, C = q.shape
    Sk = k.shape[1]
    D = C // heads
    b = None if bias is None else bias[None, None]
    out = reference_attention(q.reshape(B, Sq, heads, D), k.reshape(B, Sk, heads, D),
                              v.reshape(B, Sk, heads, D), bias=b, scale=scale)
    return out.reshape(B, Sq, C)


def mh_flash_attention_plain(q, k, v, *, scale, heads):
    return tiny_attention_plain(q, k, v, None, scale=scale, heads=heads)


def shared_bias_attention_plain(q, k, v, bias, *, scale, with_lse=False):
    out = reference_attention(q, k, v, bias=bias[None, None], scale=scale)
    if not with_lse:
        return out
    B, Sq, H, D = q.shape
    return out, _cat([_softmax_stats(_logits(q, k, bias[None, None], scale, s, e))[2]
                      for s, e in _batch_chunks(B, H, Sq, k.shape[1])])


def frame_attention_plain(q, k, v, *, scale, heads):
    B, F, HW, C = q.shape
    D = C // heads

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(B * HW, F, heads, D)

    out = reference_attention(fold(q), fold(k), fold(v), scale=scale)
    return out.reshape(B, HW, F, C).permute(0, 2, 1, 3)


def striped_v2_attention_plain(q, k, v, *, scale, heads, G=1, R=1):
    """Plain L1: the pack sizes G and R only say how the kernel walks the
    locations; the function is K4's."""
    return frame_attention_plain(q, k, v, scale=scale, heads=heads)


def diag_motion_attention_plain(q, k, v, *, scale, heads, G=1):
    """Plain L3: the softmax over the diagonal [F, F] blocks alone is K4's
    per-location attention."""
    return frame_attention_plain(q, k, v, scale=scale, heads=heads)


def fused_motion_attention_plain(q, k, v, bias, *, scale, heads, G, exp_bf16=False):
    """Plain L2: q/k/v [B, F, HW, C]; each pack of G neighbouring locations
    becomes one sequence of G*F tokens in block order (row g*F + f) and
    every head takes one softmax over all G*F keys under `bias`
    [1, G*F, G*F] (any float dtype, widened to float32), whatever the bias
    holds. With `exp_bf16` the casts of the TPU kernel in their order: the
    exponent s - max rounded to bfloat16, its exponential taken in bfloat16
    and cast to v.dtype, the denominator summed in float32 over those
    probabilities, the division after P V. Batch-chunked under
    LOGITS_BYTES_LIMIT."""
    B, F, HW, C = q.shape
    D, T, S = C // heads, HW // G, G * F

    def pack(x):    # [B, F, T*G, C] -> [B*T, G*F, heads, D]
        return x.reshape(B, F, T, G, heads, D).permute(0, 2, 3, 1, 4, 5).reshape(
            B * T, S, heads, D)

    qp, kp, vp = pack(q), pack(k), pack(v)
    if not exp_bf16:
        out = reference_attention(qp, kp, vp, bias=bias[None], scale=scale)
    else:
        outs = []
        for s, e in _batch_chunks(B * T, heads, S, S):
            logits = _logits(qp, kp, bias[None], scale, s, e)
            m = logits.amax(dim=-1, keepdim=True)
            p = torch.exp((logits - m).bfloat16()).to(v.dtype)
            denom = p.float().sum(dim=-1, keepdim=True)
            o = torch.einsum("bhqk,bkhd->bhqd", p.float(), vp[s:e].float()) / denom
            outs.append(o.permute(0, 2, 1, 3).to(q.dtype))
        out = _cat(outs)
    return out.reshape(B, T, G, F, C).permute(0, 3, 1, 2, 4).reshape(B, F, HW, C)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def tiny_attention(q, k, v, bias=None, *, scale: float, heads: int):
    """K1. q [B, Sq, H*D], k/v [B, Sk, H*D] with Sk <= 1024 and D <= 512,
    optional bias [Sq, Sk] float32 shared by every row and head. Returns
    [B, Sq, H*D]. Above D = 160 the wide kernel (csrc/tiny_attention_wide.cu)
    runs, counted in `wide_launches`; in bfloat16 both are counted in
    `tc_launches`."""
    if q.device.type == "cpu":
        tiny_attention.plain_calls += 1
        return tiny_attention_plain(q, k, v, bias, scale=scale, heads=heads)
    name = "tiny_attention"
    dt = _check_cuda(name, q, k, v)
    B, Sq, C = q.shape
    Sk = k.shape[1]
    D = C // heads
    _check_head_dim(name, D, WIDE_MAX_HEAD_DIM)
    if (C != heads * D or k.shape != (B, Sk, C) or v.shape != k.shape
            or not 1 <= Sk <= TINY_MAX_SK):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads} (Sk <= {TINY_MAX_SK})")
    if bias is not None:
        _check_bias(name, bias, q, Sq, Sk)
    out = torch.empty_like(q)
    lib = load_library()
    wide = D > MAX_HEAD_DIM
    _launch(tiny_attention, lib.i360_tiny_attention_wide if wide else lib.i360_tiny_attention,
            q, _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), B, Sq, Sk, heads, D,
            float(scale), dt, shape=(B, Sq, Sk, heads, D), wide=wide,
            tc=_on_tensor_cores(q))
    return out


def mh_flash_attention(q, k, v, *, scale: float, heads: int):
    """K2. q [B, Sq, H*D], k/v [B, Sk, H*D] with D <= 512, no bias. Returns
    [B, Sq, H*D]. Above D = 160 the wide kernel (csrc/mh_flash_wide.cu)
    runs, counted in `wide_launches`; in bfloat16 both are counted in
    `tc_launches`."""
    if q.device.type == "cpu":
        mh_flash_attention.plain_calls += 1
        return mh_flash_attention_plain(q, k, v, scale=scale, heads=heads)
    name = "mh_flash_attention"
    dt = _check_cuda(name, q, k, v)
    B, Sq, C = q.shape
    Sk = k.shape[1]
    D = C // heads
    _check_head_dim(name, D, WIDE_MAX_HEAD_DIM)
    if C != heads * D or k.shape != (B, Sk, C) or v.shape != k.shape or Sk < 1:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads}")
    out = torch.empty_like(q)
    lib = load_library()
    wide = D > MAX_HEAD_DIM
    _launch(mh_flash_attention,
            lib.i360_mh_flash_attention_wide if wide else lib.i360_mh_flash_attention,
            q, _ptr(q), _ptr(k), _ptr(v), _ptr(out), B, Sq, Sk, heads, D, float(scale), dt,
            shape=(B, Sq, Sk, heads, D), wide=wide, tc=_on_tensor_cores(q))
    return out


def shared_bias_attention(q, k, v, bias, *, scale: float, with_lse: bool = False):
    """K3. q [B, Sq, H, D], k/v [B, Sk, H, D], bias [Sq, Sk] float32 shared
    by every batch row and head. Returns [B, Sq, H, D], and with `with_lse`
    also the log-sum-exp of every query row, [B, H, Sq] float32."""
    if q.device.type == "cpu":
        shared_bias_attention.plain_calls += 1
        return shared_bias_attention_plain(q, k, v, bias, scale=scale, with_lse=with_lse)
    name = "shared_bias_attention"
    dt = _check_cuda(name, q, k, v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_head_dim(name, D)
    if k.shape != (B, Sk, H, D) or v.shape != k.shape or Sk < 1:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    _check_bias(name, bias, q, Sq, Sk)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32) if with_lse else None
    _launch(shared_bias_attention, load_library().i360_shared_bias_attention, q, _ptr(q),
            _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), B, Sq, Sk, H, D, float(scale),
            dt, shape=(B, Sq, Sk, H, D), tc=_on_tensor_cores(q), lse=with_lse)
    return (out, lse) if with_lse else out


def _check_flash(name, q, k, v, bias, *more):
    """Validate the inputs of K5a-c: q [B, Sq, H, D], k/v [B, Sk, H, D],
    `more` tensors shaped like q, bias None or float32 [1|B, 1|H, Sq, Sk].
    Returns (dtype code, B, Sq, Sk, H, D, bias batch stride, head stride)."""
    dt = _check_cuda(name, q, k, v, *more)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_head_dim(name, D)
    if (k.shape != (B, Sk, H, D) or v.shape != k.shape or Sk < 1
            or any(t.shape != q.shape for t in more)):
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} {[tuple(t.shape) for t in more]}")
    return (dt, B, Sq, Sk, H, D, *_bias_strides(name, bias, q, B, H, Sq, Sk))


def _bias_strides(name, bias, q, B, H, Sq, Sk):
    """Validate a bias None or float32 [1|B, 1|H, Sq, Sk]; return its batch
    and head strides in elements, 0 for a broadcast axis."""
    if bias is None:
        return 0, 0
    if (bias.device != q.device or bias.dtype != torch.float32 or bias.dim() != 4
            or bias.shape[0] not in (1, B) or bias.shape[1] not in (1, H)
            or tuple(bias.shape[2:]) != (Sq, Sk) or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 [1|{B}, 1|{H}, {Sq}, "
                         f"{Sk}] tensor on {q.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    return (bias.stride(0) if bias.shape[0] > 1 else 0,
            bias.stride(1) if bias.shape[1] > 1 else 0)


def _check_rows(name, q, *rows):
    """lse / delta: contiguous float32 [B, H, Sq] on q's device."""
    B, Sq, H, _ = q.shape
    for t in rows:
        if (t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: lse and delta must be contiguous float32 "
                             f"[{B}, {H}, {Sq}] tensors on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def flash_attention_lse(q, k, v, bias=None, *, scale: float):
    """K5a. q [B, Sq, H, D], k/v [B, Sk, H, D], bias None or float32
    [1|B, 1|H, Sq, Sk]. Returns (out [B, Sq, H, D] in q.dtype, lse
    [B, H, Sq] float32), the forward and the residual of the streaming
    backward."""
    if q.device.type == "cpu":
        flash_attention_lse.plain_calls += 1
        return flash_attention_lse_plain(q, k, v, bias, scale=scale)
    dt, B, Sq, Sk, H, D, bs, hs = _check_flash("flash_attention_lse", q, k, v, bias)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=q.device, dtype=torch.float32)
    _launch(flash_attention_lse, load_library().i360_flash_attention_lse, q, _ptr(q), _ptr(k),
            _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), B, Sq, Sk, H, D, bs, hs, float(scale),
            dt, shape=(B, Sq, Sk, H, D), tc=_on_tensor_cores(q))
    return out, lse


def flash_bwd_dq(q, k, v, bias, g, lse, delta, *, scale: float):
    """K5b. The query gradient of softmax(q k^T * scale + bias) v for the
    output cotangent g [B, Sq, H, D] (q's dtype), from the forward's lse
    and delta = rowsum(g * out), both [B, H, Sq] float32. Returns dq
    [B, Sq, H, D] in q.dtype."""
    if q.device.type == "cpu":
        flash_bwd_dq.plain_calls += 1
        return flash_bwd_dq_plain(q, k, v, bias, g, lse, delta, scale=scale)
    name = "flash_bwd_dq"
    dt, B, Sq, Sk, H, D, bs, hs = _check_flash(name, q, k, v, bias, g)
    _check_rows(name, q, lse, delta)
    dq = torch.empty_like(q)
    _launch(flash_bwd_dq, load_library().i360_flash_bwd_dq, q, _ptr(q), _ptr(k), _ptr(v),
            _ptr(bias), _ptr(g), _ptr(lse), _ptr(delta), _ptr(dq), B, Sq, Sk, H, D, bs, hs,
            float(scale), dt, shape=(B, Sq, Sk, H, D), tc=_on_tensor_cores(q))
    return dq


def flash_bwd_dkv(q, k, v, bias, g, lse, delta, *, scale: float):
    """K5c. The key and value gradients for the same inputs as
    `flash_bwd_dq`. Returns (dk, dv), [B, Sk, H, D] in the dtype of k."""
    if q.device.type == "cpu":
        flash_bwd_dkv.plain_calls += 1
        return flash_bwd_dkv_plain(q, k, v, bias, g, lse, delta, scale=scale)
    name = "flash_bwd_dkv"
    dt, B, Sq, Sk, H, D, bs, hs = _check_flash(name, q, k, v, bias, g)
    _check_rows(name, q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_bwd_dkv, load_library().i360_flash_bwd_dkv, q, _ptr(q), _ptr(k), _ptr(v),
            _ptr(bias), _ptr(g), _ptr(lse), _ptr(delta), _ptr(dk), _ptr(dv), B, Sq, Sk, H, D,
            bs, hs, float(scale), dt, shape=(B, Sq, Sk, H, D), tc=_on_tensor_cores(q))
    return dk, dv


def _frame_stage_bytes(F: int, D: int, G: int, HG: int) -> int:
    """Bytes of K4's q, k and v tiles in one stage of a bfloat16 block:
    frames padded to a multiple of 16, rows of G * HG heads padded to a
    multiple of 16 and 8 more (csrc/frame_attention.cu k4_row_stride)."""
    return 3 * (-(-F // 16) * 16) * (G * HG * (-(-D // 16) * 16) + 8) * 2


def frame_attention_walk(B: int, F: int, HW: int, heads: int, D: int, sms: int, G: int,
                         HG: int) -> int:
    """R, the packs of G locations x HG heads a bfloat16 K4 block walks: so
    many that each block slot the card holds (by shared memory, two stages a
    block) takes about FRAME_WAVES blocks in turn."""
    block_bytes = 2 * _frame_stage_bytes(F, D, G, HG)
    slots = sms * max(1, min(16, SM_SHARED_BYTES // (block_bytes + 1024)))
    packs = B * -(-HW // G) * (heads // HG)
    return max(1, -(-packs // (slots * FRAME_WAVES)))


def frame_attention_plan(B: int, F: int, HW: int, heads: int, D: int, sms: int):
    """(G, HG, R) of K4's bfloat16 kernel (csrc/frame_attention.cu) on a card
    with `sms` SMs: a pack is G neighbouring locations x HG of their heads
    (HG divides heads), and a block walks R packs (`frame_attention_walk`).
    The pack is the largest (G * HG problems; all heads before more
    locations, so that a frame's run stays one contiguous read) whose tiles
    stay within FRAME_STAGE_BYTES a stage; one location of one head if none
    does."""
    fits = [(G * HG, HG, G) for HG in range(1, heads + 1) if heads % HG == 0
            for G in (1, 2, 4, 8)
            if G <= max(1, HW) and _frame_stage_bytes(F, D, G, HG) <= FRAME_STAGE_BYTES]
    _, HG, G = max(fits) if fits else (1, 1, 1)
    return G, HG, frame_attention_walk(B, F, HW, heads, D, sms, G, HG)


def frame_attention(q, k, v, *, scale: float, heads: int):
    """K4. q/k/v [B, F, HW, C] with F <= 64; each location attends over its
    own F frames with `heads` heads of C // heads. Returns [B, F, HW, C].
    bfloat16 takes the tensor cores in packs of `frame_attention_plan`."""
    if q.device.type == "cpu":
        frame_attention.plain_calls += 1
        return frame_attention_plain(q, k, v, scale=scale, heads=heads)
    name = "frame_attention"
    dt = _check_cuda(name, q, k, v)
    B, F, HW, C = q.shape
    D = C // heads
    _check_head_dim(name, D)
    if C != heads * D or k.shape != q.shape or v.shape != q.shape \
            or not 1 <= F <= FRAME_MAX_F:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads} (F <= {FRAME_MAX_F})")
    out = torch.empty_like(q)
    tc = _on_tensor_cores(q)
    plan = frame_attention_plan(B, F, HW, heads, D, torch.cuda.get_device_properties(
        q.device).multi_processor_count) if tc else (1, 1, 1)
    _launch(frame_attention, load_library().i360_frame_attention, q, _ptr(q), _ptr(k),
            _ptr(v), _ptr(out), B, F, HW, heads, D, float(scale), dt, *plan,
            shape=(B, F, HW, C, heads), tc=tc)
    return out


def flash_attention_t(q, k, v, bias=None, *, scale: float):
    """K6a. Sequence-minor inputs: q [B, H, D, Sq], k/v [B, H, D, Sk], bias
    None or float32 [1|B, 1|H, Sq, Sk]. Returns [B, H, Sq, D] in q.dtype; no
    lse, no backward."""
    if q.device.type == "cpu":
        flash_attention_t.plain_calls += 1
        return flash_attention_t_plain(q, k, v, bias, scale=scale)
    name = "flash_attention_t"
    dt = _check_cuda(name, q, k, v)
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, H, D, Sq], got {tuple(q.shape)}")
    B, H, D, Sq = q.shape
    Sk = k.shape[-1]
    _check_head_dim(name, D)
    if k.shape != (B, H, D, Sk) or v.shape != k.shape or Sk < 1:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    bs, hs = _bias_strides(name, bias, q, B, H, Sq, Sk)
    out = torch.empty(B, H, Sq, D, device=q.device, dtype=q.dtype)
    _launch(flash_attention_t, load_library().i360_flash_attention_t, q, _ptr(q), _ptr(k),
            _ptr(v), _ptr(bias), _ptr(out), B, Sq, Sk, H, D, bs, hs, float(scale), dt,
            shape=(B, Sq, Sk, H, D), tc=_on_tensor_cores(q))
    return out


def shared_bias_attention_folded(q, k, v, bias, *, scale: float, with_lse: bool = False,
                                 t_rows: int = FOLDED_T_ROWS):
    """K6b. Batch and head folded: q [BH, Sq, D], k/v [BH, Sk, D], one bias
    [Sq, Sk] in float32 or bfloat16 shared by all BH rows. A block loads
    each bias tile once and takes up to `t_rows` folded rows under it (in
    bfloat16 on the tensor cores at most two, csrc/shared_bias_folded.cu
    K6B_MAX_G).
    Returns [BH, Sq, D] in q.dtype, and with `with_lse` also the lse
    [BH, Sq] float32."""
    if q.device.type == "cpu":
        shared_bias_attention_folded.plain_calls += 1
        return shared_bias_attention_folded_plain(q, k, v, bias, scale=scale,
                                                  with_lse=with_lse)
    name = "shared_bias_attention_folded"
    dt = _check_cuda(name, q, k, v)
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be [BH, Sq, D], got {tuple(q.shape)}")
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    _check_head_dim(name, D)
    if k.shape != (BH, Sk, D) or v.shape != k.shape or Sk < 1 or t_rows < 1:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} t_rows={t_rows}")
    if (bias.device != q.device or bias.dtype not in _DTYPE_CODE
            or tuple(bias.shape) != (Sq, Sk) or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 or bfloat16 "
                         f"[{Sq}, {Sk}] tensor on {q.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    out = torch.empty_like(q)
    lse = torch.empty(BH, Sq, device=q.device, dtype=torch.float32) if with_lse else None
    _launch(shared_bias_attention_folded, load_library().i360_shared_bias_attention_folded, q,
            _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(out), _ptr(lse), BH, Sq, Sk, D,
            int(t_rows), float(scale), dt, _DTYPE_CODE[bias.dtype], shape=(BH, Sq, Sk, D),
            tc=_on_tensor_cores(q), lse=with_lse)
    return (out, lse) if with_lse else out


def dense_matmul(x, w, *, linear_layout: bool = False):
    """K7. x [N, K] @ w with float32 accumulation, cast to x.dtype: w is
    [K, M], or with `linear_layout` [M, K] as `nn.Linear` stores its weight
    (x @ w^T, no transposed copy). Any N, K, M >= 1. Returns [N, M]."""
    if x.device.type == "cpu":
        dense_matmul.plain_calls += 1
        return dense_matmul_plain(x, w, linear_layout=linear_layout)
    name = "dense_matmul"
    dt = _check_cuda(name, x, w)
    if x.dim() != 2 or w.dim() != 2 or w.shape[1 if linear_layout else 0] != x.shape[1] \
            or 0 in w.shape:
        raise ValueError(f"{name}: bad shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"linear_layout={linear_layout}")
    N, K = x.shape
    M = w.shape[0 if linear_layout else 1]
    out = torch.empty(N, M, device=x.device, dtype=x.dtype)
    ws_k, ws_m = (1, K) if linear_layout else (M, 1)
    _launch(dense_matmul, load_library().i360_dense_matmul, x, _ptr(x), _ptr(w), _ptr(out),
            N, K, M, ws_k, ws_m, dt, shape=(N, K, M), tc=_on_tensor_cores(x))
    return out


def _padded_row(elems: int, itemsize: int) -> int:
    """Elements of a shared-memory row that holds `elems` values of
    `itemsize` bytes and is an odd number of 4-byte words long, so that rows
    read side by side by the lanes of a warp fall into different banks."""
    words = -(-elems * itemsize // 4) | 1
    return words * 4 // itemsize


def _check_motion(name: str, q, k, v, heads: int, G: int):
    """Shapes of the lab variants, on any device: q/k/v [B, F, HW, C] alike,
    C a multiple of heads, HW a multiple of the pack size G. Returns
    (B, F, HW, C, D)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or heads < 1 \
            or q.shape[3] % heads:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} heads={heads}")
    B, F, HW, C = q.shape
    if G < 1 or HW % G:
        raise ValueError(f"{name}: HW={HW} is not a multiple of the pack size G={G}")
    return B, F, HW, C, C // heads


def striped_v2_smem_bytes(G: int, F: int, C: int, heads: int, itemsize: int) -> int:
    """Shared memory of one L1 block: q, k, v of a pack in the storage type
    and the float logits of its G * heads problems."""
    return 3 * F * _padded_row(G * C, itemsize) * itemsize + G * heads * F * (F + 1) * 4


def fused_motion_smem_bytes(G: int, F: int, D: int, itemsize: int) -> int:
    """Shared memory of one L2 block: K and V of a head and pack, a query
    tile, its float logits and denominators, and the partial sums of the key
    slices of P V (as many slices, up to 8, as give each of the block's 512
    threads an item of 4 rows and one column, or two columns of an even head
    dim)."""
    S = G * F
    cols = D // 2 if D % 2 == 0 else D
    slices = max(1, min(8, S, FUSED_THREADS // (FUSED_Q_ROWS // 4 * cols)))
    return ((2 * S + FUSED_Q_ROWS) * _padded_row(D, itemsize) * itemsize
            + FUSED_Q_ROWS * (S + 2 + slices * D) * 4)


def diag_motion_plan(G: int, F: int, D: int, heads: int, itemsize: int):
    """(heads staged at a time, row stride in elements, warps, shared-memory
    bytes) of one L3 block: the most heads with which two blocks fit an SM,
    else the most with which one does. Raises when one head does not fit."""
    for limit in (SMEM_LIMIT // 2 - 1024, SMEM_LIMIT):
        for hg in range(heads, 0, -1):
            rs = _padded_row(hg * D, itemsize)
            warps = min(DIAG_MAX_WARPS, G * hg)
            smem = 3 * G * F * rs * itemsize + warps * F * F * 4
            if smem <= limit:
                return hg, rs, warps, smem
    raise ValueError(f"diag_motion_attention: a pack of G={G} locations x F={F} frames of one "
                     f"head of {D} does not fit {SMEM_LIMIT} bytes of shared memory")


def striped_v2_attention(q, k, v, *, scale: float, heads: int, G: int, R: int):
    """L1. q/k/v [B, F, HW, C]; K4's function, with one block owning R packs
    of G neighbouring locations and all heads. HW % G == 0 and
    (HW / G) % R == 0; raises for a (G, C, F) whose pack does not fit a
    block's shared memory. Returns [B, F, HW, C]."""
    name = "striped_v2_attention"
    B, F, HW, C, D = _check_motion(name, q, k, v, heads, G)
    if R < 1 or (HW // G) % R:
        raise ValueError(f"{name}: {HW // G} packs are not a multiple of R={R}")
    if q.device.type == "cpu":
        striped_v2_attention.plain_calls += 1
        return striped_v2_attention_plain(q, k, v, scale=scale, heads=heads, G=G, R=R)
    dt = _check_cuda(name, q, k, v)
    _check_head_dim(name, D)
    smem = striped_v2_smem_bytes(G, F, C, heads, q.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: a pack of G={G} x C={C} x F={F} needs {smem} bytes of "
                         f"shared memory, a block has {SMEM_LIMIT}")
    out = torch.empty_like(q)
    _launch(striped_v2_attention, load_library().i360_striped_v2_attention, q, _ptr(q), _ptr(k),
            _ptr(v), _ptr(out), B, F, HW, heads, D, G, R, _padded_row(G * C, q.element_size()),
            float(scale), dt, shape=(B, F, HW, C, heads, G, R))
    return out


def fused_motion_attention(q, k, v, bias, *, scale: float, heads: int, G: int,
                           exp_bf16: bool = False):
    """L2. q/k/v [B, F, HW, C]; each pack of G neighbouring locations attends
    as one sequence of G*F tokens in block order (row g*F + f) under `bias`
    [1, G*F, G*F], float32 or bfloat16, read as an operand (-inf allowed, a
    fully masked row is not). `exp_bf16` takes the exponential in bfloat16
    and divides after P V. Raises for a (G, F, D) that does not fit a
    block's shared memory. Returns [B, F, HW, C]."""
    name = "fused_motion_attention"
    B, F, HW, C, D = _check_motion(name, q, k, v, heads, G)
    S = G * F
    if (tuple(bias.shape) != (1, S, S) or bias.device != q.device
            or bias.dtype not in _DTYPE_CODE or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous float32 or bfloat16 "
                         f"[1, {S}, {S}] tensor on {q.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}")
    if q.device.type == "cpu":
        fused_motion_attention.plain_calls += 1
        return fused_motion_attention_plain(q, k, v, bias, scale=scale, heads=heads, G=G,
                                            exp_bf16=exp_bf16)
    dt = _check_cuda(name, q, k, v)
    _check_head_dim(name, D)
    smem = fused_motion_smem_bytes(G, F, D, q.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: K and V of G={G} x F={F} tokens of head dim {D} need {smem} "
                         f"bytes of shared memory, a block has {SMEM_LIMIT}")
    out = torch.empty_like(q)
    _launch(fused_motion_attention, load_library().i360_fused_motion_attention, q, _ptr(q),
            _ptr(k), _ptr(v), _ptr(bias), _ptr(out), B, F, HW, heads, D, G,
            _padded_row(D, q.element_size()), float(scale), int(exp_bf16), dt,
            _DTYPE_CODE[bias.dtype], shape=(B, F, HW, C, heads, G, bool(exp_bf16)))
    return out


def diag_motion_attention(q, k, v, *, scale: float, heads: int, G: int):
    """L3. q/k/v [B, F, HW, C] with F <= 32; K4's function with no bias and
    no masked logit, one warp per (location, head), a block owning G
    neighbouring locations. Raises beyond F = 32 and for a pack that does not
    fit a block's shared memory. Returns [B, F, HW, C]."""
    name = "diag_motion_attention"
    B, F, HW, C, D = _check_motion(name, q, k, v, heads, G)
    if not 1 <= F <= DIAG_MAX_F:
        raise ValueError(f"{name}: F={F} frames outside 1..{DIAG_MAX_F}")
    if q.device.type == "cpu":
        diag_motion_attention.plain_calls += 1
        return diag_motion_attention_plain(q, k, v, scale=scale, heads=heads, G=G)
    dt = _check_cuda(name, q, k, v)
    _check_head_dim(name, D)
    hg, rs, warps, _ = diag_motion_plan(G, F, D, heads, q.element_size())
    out = torch.empty_like(q)
    _launch(diag_motion_attention, load_library().i360_diag_motion_attention, q, _ptr(q),
            _ptr(k), _ptr(v), _ptr(out), B, F, HW, heads, D, G, hg, rs, warps, float(scale),
            dt, shape=(B, F, HW, C, heads, G))
    return out


LAB_KERNELS = (striped_v2_attention, fused_motion_attention, diag_motion_attention)
KERNELS = (tiny_attention, mh_flash_attention, shared_bias_attention, frame_attention,
           flash_attention_lse, flash_bwd_dq, flash_bwd_dkv, flash_attention_t,
           shared_bias_attention_folded, dense_matmul, *LAB_KERNELS)


def reset_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.wide_launches = 0
        fn.tc_launches = 0
        fn.lse_launches = 0
        fn.shape_launches = collections.Counter()
        fn.plain_calls = 0


def counts() -> dict:
    """{wrapper name: {"launches": n, "plain_calls": n}}."""
    return {fn.__name__: {"launches": fn.launches, "plain_calls": fn.plain_calls}
            for fn in KERNELS}


def shape_counts() -> dict:
    """{(wrapper name, shape): launches}; shape is (B, Sq, Sk, H, D) for
    K1-K3, K5a-c and K6a, (B, F, HW, C, heads) for K4, (BH, Sq, Sk, D) for
    K6b, (N, K, M) for K7, and K4's shape followed by (G, R) for L1,
    (G, exp_bf16) for L2 and (G,) for L3."""
    return {(fn.__name__, shape): n for fn in KERNELS
            for shape, n in fn.shape_launches.items()}


def wide_counts() -> dict:
    """{wrapper name: launches of its wide (D > 160) kernel}, K1 and K2."""
    return {fn.__name__: fn.wide_launches for fn in (tiny_attention, mh_flash_attention)}


TC_KERNELS = (tiny_attention, mh_flash_attention, shared_bias_attention, frame_attention,
              flash_attention_lse, flash_bwd_dq, flash_bwd_dkv, flash_attention_t,
              shared_bias_attention_folded, dense_matmul)


def tc_counts() -> dict:
    """{wrapper name: launches on the tensor cores (bfloat16)}, K1-K4, K5a,
    K5b, K5c, K6a, K6b and K7."""
    return {fn.__name__: fn.tc_launches for fn in TC_KERNELS}


def lse_counts() -> dict:
    """{wrapper name: launches that also wrote the lse}, K3."""
    return {shared_bias_attention.__name__: shared_bias_attention.lse_launches}


reset_counts()
