"""Group-wise 4-bit weight-only matrix product: the wrappers of the CUDA
kernels `csrc/q4_gemv.cu`, `csrc/q4_mma.cu` and `csrc/q4_wgmma.cu` and
their plain PyTorch version.

Counterpart of moshi_tpu/ops/q4matmul.py (`q4gemm`, `q4gemm_stacked`),
which take x of any row count M.  A member of a stacked weight is a view
here, so one entry point covers both.  `q4_gemv` is the entry point: on a
CPU tensor it runs `q4_gemv_plain`; on a CUDA tensor, by M and dtype
(`route`):
- bf16 x of more than TILE_ROWS rows (the offline forward's B * T) ->
  `q4_wgmma`: wgmma over 128-row tiles, each weight unpacked once per tile
  into shared memory, one launch per call (its din-split reduce, where
  `wgmma_plan_splits` splits, is a second kernel of the same call);
- bf16 x of MMA_MIN_BATCH..TILE_ROWS rows (the decoding batch) -> `q4_mma`
  on the tensor cores (mma.sync), one launch per call, split as
  `mma_plan_splits` says;
- f32 x, bf16 x of one row, and shapes the tensor-core kernels do not take
  (`use_mma`) -> the `q4_gemv` kernel on the CUDA cores, one launch per
  MAX_BATCH rows: the wrapper loops over chunks of at most 16 rows,
  ceil(M / 16) launches a call (f32 is the parity dtype; no main path runs
  it on the card), each launch planned by `gemv_plan` (shared with the
  int8_gemv kernel of ops/qmatmul.py).
Either way a CUDA tensor launches a kernel or raises.  `q4_linear` is
differentiable in x through `FrozenLinear` (training's backward, a
torch.matmul on the dequantized weight); with no grad to record it runs the
route alone.
"""

import functools
import math
from typing import NamedTuple

import torch

from ..utils.quantize import dequantize4
from . import build

MAX_BATCH = 16        # gemv::kMaxBatch: rows of one q4_gemv (and int8) launch
TILE_ROWS = MAX_BATCH  # q4_mma.cu kTileRows: the most rows of x q4_mma takes
MAX_SPLIT_ROWS = 1024  # din rows a q4_mma block stages in shared memory
# q4_mma takes bf16 calls of MMA_MIN_BATCH rows and more; B = 1 stays on the
# q4_gemv kernel (PERF.md, the crossover table).
MMA_MIN_BATCH = 2
MMA_WARP_COLS = 64    # q4_mma.cu kWarpCols: eight n8 tiles
MMA_BLOCK_COLS = 4 * MMA_WARP_COLS  # q4_mma.cu kBlockCols: 4 warps
WGMMA_ROWS = 128      # q4_wgmma.cu kRows: the rows of x a block takes
WGMMA_COLS = 128      # q4_wgmma.cu kCols: the columns of y a block takes
WGMMA_MIN_SPLIT_ROWS = 256  # din rows of a q4_wgmma split, at least: four stages
# the split planner's model of q4_wgmma on the card: the flop/s its blocks
# reach together (on an H100 at M = 256, ~27% of the dense bf16 peak,
# PERF.md), the device memory bytes/s of an H100 SXM (NVIDIA's data sheet),
# and a launch's seconds
WGMMA_MODEL = (270e12, 3.35e12, 2e-6)
WGMMA_WAVE_FILL = 0.9  # the share of the SMs a plan's first wave must fill
# the most f32 partial sums [splits, M, dout] a q4_wgmma plan asks for;
# q4_mma's plans stay under it too (the 7B's widest at 16 rows: 8.2 MB)
MMA_WORKSPACE_BYTES = 32 * 2 ** 20


# the CUDA-core GEMV kernels (csrc/gemv_common.cuh): a lane's columns, warps
# over din slices, a cluster of blocks over din added in distributed shared
# memory
GEMV_MAX_ACC = 64       # gemv::kMaxAcc: batch rows x columns a lane sums
Q4_MAX_ACC = GEMV_MAX_ACC // 4  # q4_gemv.cu kMaxAcc: a group's sums beside the total
GEMV_MAX_WARPS = 8      # gemv::kMaxWarps
GEMV_MAX_CLUSTER = 8    # gemv::kMaxCluster
GEMV_BATCH_ROWS = 8     # gemv::kBatchRows: weight rows a warp loads at a time
GEMV_RING_BYTES = 8 * 1024  # gemv::kRingBytes: a warp's ring of them in shared memory
GEMV_X_PAD = 8          # gemv::kXPad
GEMV_SMEM_LIMIT = 227 * 1024  # gemv::kSmemLimit
GEMV_X_BYTES = 64 * 1024  # the most staged x (f32 [batch, rows]) a plan gives a block
GEMV_WARPS = 8          # warps a block (with their rings ~70 KB of shared memory at B = 1)
GEMV_SM_SMEM = 228 * 1024  # an H100 SM's shared memory, which its blocks share
# the least warps a plan's wave puts on an SM on average, where a lane's
# columns can be cut to reach it
GEMV_MIN_WARPS_PER_SM = 3.5


# the fastest plans (cols, warps, cluster) of the B = 1 frame's q4 shapes,
# measured on an H100 (132 SMs, 700 W) by scripts/time_gemv_plans.py, where
# gemv_plan's rule comes within 7-25% (PERF.md): taken on a card of as many
# SMs, where the operands allow the columns and the plan fits one wave
GEMV_TUNED_SMS = 132
GEMV_TUNED = {("q4", 4096, 12288, 1): (16, 8, 8), ("q4", 4096, 4096, 1): (16, 8, 8),
              ("q4", 4096, 22528, 1): (16, 4, 8), ("q4", 11264, 4096, 1): (8, 8, 6),
              ("q4", 4096, 32000, 1): (16, 8, 2)}


class GemvPlan(NamedTuple):
    """A launch of a CUDA-core GEMV kernel: `cols` columns a lane, `warps`
    warps a block, `cluster` blocks a column tile, rank r taking din rows
    [r * rows_per_block, ...), x staged `seg_rows` din rows at a time."""
    cols: int
    warps: int
    cluster: int
    rows_per_block: int
    seg_rows: int


def gemv_max_cols(batch: int, max_acc: int = GEMV_MAX_ACC) -> int:
    """gemv::max_cols: the columns a lane may own at `batch` rows, at most
    max_acc sums a lane (GEMV_MAX_ACC for the int8_gemv kernel,
    Q4_MAX_ACC for the q4_gemv kernel)."""
    return 16 if batch <= max_acc // 16 else 8 if batch <= max_acc // 8 else 4


def gemv_ring_bytes(kind: str, batch: int, cols: int) -> int:
    """A warp's ring of weight rows in shared memory (q4_gemv.cu /
    int8_gemv.cu `ring_bytes`): stages of GEMV_BATCH_ROWS rows (q4 above 8
    rows of x: 2) of the warp's 32 * cols bytes (int8 at 4 columns: 144, the
    word past them and padding), as many as GEMV_RING_BYTES hold, 2..8."""
    if kind == "q4":
        stage = (2 if batch > 8 else GEMV_BATCH_ROWS) * 32 * cols
    else:
        stage = GEMV_BATCH_ROWS * (144 if cols == 4 else 32 * cols)
    return max(2, min(8, GEMV_RING_BYTES // stage)) * stage


def gemv_smem_bytes(batch: int, cols: int, warps: int, ranks: int, seg_rows: int,
                    ring: int) -> int:
    """gemv::smem_bytes: each warp's sums, the slots of the sums the other
    ranks send (a rank owns ceil(batch * 8 * cols / ranks) quads of four
    outputs), x f32 [batch, seg_rows rounded up to GEMV_X_PAD], then each
    warp's ring of `ring` bytes."""
    quads = -(-batch * 8 * cols // ranks)
    return (4 * (warps * batch * 32 * cols + ranks * quads * 4
                 + batch * -(-seg_rows // GEMV_X_PAD) * GEMV_X_PAD) + warps * ring)


def gemv_resident_model(kind: str, batch: int, num_sms: int):
    """gemv_plan's `resident` without the card: each SM holds as many blocks
    as its shared memory does, at most 8 (the card's count, which also sees
    registers and how clusters pack into its GPCs, comes from the kernel's
    `*_resident` entry)."""
    def resident(cols, warps, cluster, seg):
        smem = gemv_smem_bytes(batch, cols, warps, cluster, seg,
                               gemv_ring_bytes(kind, batch, cols))
        return 0 if smem > GEMV_SMEM_LIMIT else min(8, GEMV_SM_SMEM // (smem + 1024)) * num_sms
    return resident


def gemv_plan(kind: str, din: int, dout: int, batch: int, num_sms: int, grain: int,
              cols_options: tuple[int, ...], resident=None) -> GemvPlan:
    """The plan of a CUDA-core GEMV launch ("q4": grain = the group size;
    "int8": 1) of `batch` rows; cols_options are the columns a lane may own
    for these operands, largest first; resident(cols, warps, cluster,
    seg_rows) is how many blocks of such a launch the card holds at once
    (gemv_resident_model by default).  GEMV_WARPS warps a block.  For each
    cols, the cluster is the largest (at most GEMV_MAX_CLUSTER, and few
    enough that every warp has a grain of din and GEMV_BATCH_ROWS rows)
    whose blocks all fit at once: one wave, since a second wave of a few
    blocks costs a whole block's time.  The plan takes the largest cols
    whose wave has GEMV_MIN_WARPS_PER_SM warps an SM (more columns a lane,
    fewer instructions a byte), else the smallest.  rows_per_block is a
    multiple of grain, ranks past din dropped; seg_rows is rows_per_block,
    or the most whole grains whose x fits GEMV_X_BYTES.  A shape of
    GEMV_TUNED takes its measured plan instead on a card of GEMV_TUNED_SMS
    SMs, where that plan fits one wave."""
    resident = resident or gemv_resident_model(kind, batch, num_sms)
    grains = -(-din // grain)

    def cut(cols, warps, cluster):
        rows = -(-grains // cluster) * grain
        seg = min(rows, max(grain, GEMV_X_BYTES // (4 * batch) // grain * grain))
        return GemvPlan(cols, warps, -(-din // rows), rows, seg)

    tuned = GEMV_TUNED.get((kind, din, dout, batch))
    if num_sms == GEMV_TUNED_SMS and tuned and tuned[0] in cols_options:
        plan = cut(*tuned)
        if -(-dout // (32 * plan.cols)) * plan.cluster <= resident(*plan[:3], plan.seg_rows):
            return plan
    warps = GEMV_WARPS
    per_warp = max(1, GEMV_BATCH_ROWS // grain)  # grains a warp takes at least
    most = max(1, min(GEMV_MAX_CLUSTER, grains // (warps * per_warp)))
    best = None
    for cols in cols_options:
        tiles = -(-dout // (32 * cols))
        for cluster in range(most, 0, -1):
            best = cut(cols, warps, cluster)
            if tiles * cluster <= resident(cols, warps, cluster, best.seg_rows) or cluster == 1:
                break
        if tiles * cluster * warps >= GEMV_MIN_WARPS_PER_SM * num_sms:
            break
    return best


_resident_cache: dict = {}


def gemv_resident(kind: str, batch: int, bf16: bool, device: torch.device):
    """gemv_plan's `resident` on the card: the kernel's `*_resident` C entry
    (cudaOccupancyMaxActiveClusters), cached by plan."""
    lib = build.load(f"{kind}_gemv")
    fn = getattr(lib, f"{kind}_gemv_resident")

    def resident(cols, warps, cluster, seg):
        key = (kind, batch, bf16, device.index or 0, cols, warps, cluster, seg)
        if key not in _resident_cache:
            with torch.cuda.device(device):
                n = fn(batch, cols, warps, cluster, seg, int(bf16))
            if n < 0:
                msg = lib.cuda_error_string(-n).decode()
                raise RuntimeError(f"{kind}_gemv_resident: CUDA error {-n} ({msg})")
            _resident_cache[key] = n
        return _resident_cache[key]
    return resident


def q4_gemv_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Dequantize to x.dtype, then matmul: the order of the JAX package's
    CPU path (`dot(x, QTensor4.astype(x.dtype))`)."""
    return torch.matmul(x, dequantize4(q, scale, x.dtype))


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _split(din: int, group_size: int, want: int, max_rows: int) -> tuple[int, int]:
    """(groups_per_split, splits): din cut into about `want` splits of whole
    groups, at least as many as keep a split within max_rows rows."""
    groups = din // group_size
    want = max(want, 1, -(-din // max_rows))
    gps = max(1, -(-groups // min(want, groups)))
    gps = min(gps, max(1, max_rows // group_size))
    return gps, -(-groups // gps)


def mma_plan_splits(din: int, dout: int, group_size: int, num_sms: int) -> tuple[int, int]:
    """(groups_per_split, splits) of q4_mma (x of at most TILE_ROWS rows,
    one row tile): as many blocks of MMA_BLOCK_COLS columns as fit four to
    an SM (one wave: q4_mma's registers let four blocks share an SM, and a
    fifth block per SM would wait for a second wave), at most
    MAX_SPLIT_ROWS rows per block (bf16 [16, rows + 8] of staged x stays
    within 48 KB)."""
    col_blocks = -(-dout // MMA_BLOCK_COLS)
    return _split(din, group_size, 4 * num_sms // col_blocks, MAX_SPLIT_ROWS)


def wgmma_splits(din: int, dout: int, rows: int, num_sms: int, grain: int,
                 min_split_rows: int, weight_bytes: float) -> tuple[int, int]:
    """(grains_per_split, splits) of a wgmma kernel (q4_wgmma, int8_wgmma)
    for x of `rows` rows: din cut into whole grains of `grain` rows.  A
    block takes WGMMA_ROWS x WGMMA_COLS of y and has an SM to itself, so the
    blocks run in waves of num_sms.  Where the tiles are under one wave, din
    is split until the grid fills one (at least WGMMA_WAVE_FILL of the SMs,
    as far as the limits below allow); of the plans that do, the plan takes
    the fewest splits of the least modelled time (WGMMA_MODEL): a block's
    time is the larger of its flops (the rows of its live warpgroups) at an
    SM's share of the kernel's rate and its weights (`weight_bytes` a
    weight, scales included) at its share of the device memory rate, times
    the waves; a split adds the reduce's pass over the f32 partial sums
    (written and read) and a launch.  Each split has at least min_split_rows
    din rows, and the partials [splits, rows, dout] stay within
    MMA_WORKSPACE_BYTES."""
    flops_per_s, bytes_per_s, launch_s = WGMMA_MODEL
    tiles = -(-rows // WGMMA_ROWS) * -(-dout // WGMMA_COLS)
    live = min(WGMMA_ROWS, -(-rows // 64) * 64)
    grains = -(-din // grain)
    most = min(grains, max(1, din // min_split_rows),
               max(1, MMA_WORKSPACE_BYTES // (4 * rows * dout)))
    plans = []
    for want in range(1, most + 1):
        gps = -(-grains // want)
        splits = -(-grains // gps)
        k, blocks = gps * grain, tiles * splits
        block_s = max(2 * live * WGMMA_COLS * k / (flops_per_s / num_sms),
                      k * WGMMA_COLS * weight_bytes / (bytes_per_s / min(blocks, num_sms)))
        t = -(-blocks // num_sms) * block_s
        if splits > 1:
            t += (8 * splits + 2) * rows * dout / bytes_per_s + launch_s
        plans.append((blocks < WGMMA_WAVE_FILL * num_sms, t, splits, gps))
    _, _, splits, gps = min(plans)
    return gps, splits


def wgmma_plan_splits(din: int, dout: int, group_size: int, num_sms: int,
                      rows: int) -> tuple[int, int]:
    """(groups_per_split, splits) of q4_wgmma for x of `rows` rows
    (wgmma_splits): din split into whole groups of at least
    WGMMA_MIN_SPLIT_ROWS rows, half a byte of packed weight and 4 / gs of
    scale a weight."""
    return wgmma_splits(din, dout, rows, num_sms, group_size, WGMMA_MIN_SPLIT_ROWS,
                        0.5 + 4 / group_size)


def use_mma(batch: int, dtype: torch.dtype, group_size: int, dout: int) -> bool:
    """Whether a CUDA call of q4_gemv goes to a tensor-core kernel (q4_mma
    or q4_wgmma): bf16 x of at least MMA_MIN_BATCH rows (no upper limit), a
    group size that is a multiple of 16 (at most MAX_SPLIT_ROWS) and dout a
    multiple of MMA_WARP_COLS."""
    return (dtype == torch.bfloat16 and batch >= MMA_MIN_BATCH
            and group_size % 16 == 0 and group_size <= MAX_SPLIT_ROWS
            and dout % MMA_WARP_COLS == 0)


def route(batch: int, dtype: torch.dtype, group_size: int, dout: int) -> str:
    """The kernel a CUDA call of q4_gemv launches: "q4_wgmma" for what
    use_mma admits above TILE_ROWS rows, "q4_mma" for what it admits up to
    TILE_ROWS, else "q4_gemv"."""
    if not use_mma(batch, dtype, group_size, dout):
        return "q4_gemv"
    return "q4_wgmma" if batch > TILE_ROWS else "q4_mma"


def _check(x, q, scale):
    if not (x.device == q.device == scale.device):
        raise ValueError(f"q4_gemv: tensors on {x.device}, {q.device}, {scale.device}")
    if x.ndim != 2 or q.ndim != 2 or scale.ndim != 3 or scale.shape[1] != 1:
        raise ValueError(f"q4_gemv: shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    B, din = x.shape
    p2, dout = q.shape
    G = scale.shape[0]
    if 2 * p2 != din or scale.shape[2] != dout or din % G:
        raise ValueError(f"q4_gemv: x {tuple(x.shape)} does not match q "
                         f"{tuple(q.shape)} / scale {tuple(scale.shape)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"q4_gemv: q {q.dtype}, scale {scale.dtype}")


def _check_cuda(name, x, q, scale, q_align):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not (x.is_contiguous() and q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if q.data_ptr() % q_align or scale.data_ptr() % 16:
        raise ValueError(f"{name}: q must be {q_align}-byte and scale 16-byte aligned")


def q4_gemv(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [B, din] bf16/f32; q [din/2, dout] int8; scale [din/gs, 1, dout]
    f32 -> [B, dout] in x.dtype.  The `q4_gemv` kernel's launches are
    counted in `q4_gemv.launches`, q4_mma's in `q4_mma.launches`,
    q4_wgmma's in `q4_wgmma.launches`."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    kernel = route(x.shape[0], x.dtype, x.shape[1] // scale.shape[0], q.shape[1])
    return {"q4_wgmma": q4_wgmma, "q4_mma": q4_mma, "q4_gemv": q4_gemv_kernel}[kernel](
        x, q, scale)


def q4_gemv_plan(rows: int, din: int, q: torch.Tensor, group_size: int, bf16: bool,
                 device: torch.device) -> GemvPlan:
    """The plan of a q4_gemv kernel launch of `rows` rows (at most
    MAX_BATCH) on q: a lane's 16, 8 or 4 bytes, as dout and q are aligned;
    the blocks the card holds at once from the kernel itself."""
    dout = q.shape[-1]
    cols = tuple(c for c in (16, 8, 4) if c <= gemv_max_cols(rows, Q4_MAX_ACC)
                 and dout % c == 0 and q.data_ptr() % c == 0)
    return gemv_plan("q4", din, dout, rows, _num_sms(device.index or 0), group_size, cols,
                     gemv_resident("q4", rows, bf16, device))


def q4_gemv_kernel(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q4_gemv's function through the `q4_gemv` kernel (CUDA cores), whatever
    `use_mma` says: one launch per chunk of at most MAX_BATCH rows of x,
    ceil(M / MAX_BATCH) a call; on a CPU tensor the plain version."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    _check_cuda("q4_gemv", x, q, scale, 4)
    M, din = x.shape
    dout = q.shape[1]
    gs = din // scale.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q4_gemv: x dtype {x.dtype}")
    if M < 1:
        raise ValueError(f"q4_gemv: {M} rows")
    B = min(M, MAX_BATCH)
    if gs % 2 or dout % 4 or 4 * B * gs > GEMV_X_BYTES:
        raise ValueError(f"q4_gemv: group size {gs} must be even and at most "
                         f"{GEMV_X_BYTES // (4 * B)}, dout {dout} a multiple of 4")
    lib = build.load("q4_gemv")
    out = torch.empty((M, dout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for r0 in range(0, M, MAX_BATCH):
        rows = min(MAX_BATCH, M - r0)
        plan = q4_gemv_plan(rows, din, q, gs, x.dtype == torch.bfloat16, x.device)
        xc, oc = x[r0:r0 + rows], out[r0:r0 + rows]
        err = lib.q4_gemv(xc.data_ptr(), q.data_ptr(), scale.data_ptr(), oc.data_ptr(), rows,
                          din, dout, gs, *plan, int(x.dtype == torch.bfloat16), stream)
        build.check(lib, err, "q4_gemv")
        q4_gemv.launches += 1
    return out


def q4_mma(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q4_gemv's function through the `q4_mma` kernel (tensor cores), one
    launch per call: x bf16 of 1..TILE_ROWS rows, gs a multiple of 16, dout
    a multiple of MMA_WARP_COLS; on a CPU tensor the plain version."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    _check_cuda("q4_mma", x, q, scale, 8)
    B, din = x.shape
    dout = q.shape[1]
    gs = din // scale.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"q4_mma: x dtype {x.dtype}, not bfloat16")
    if not 1 <= B <= TILE_ROWS:
        raise ValueError(f"q4_mma: {B} rows, not 1..{TILE_ROWS} (q4_wgmma takes more)")
    if gs % 16 or gs > MAX_SPLIT_ROWS or dout % MMA_WARP_COLS:
        raise ValueError(f"q4_mma: group size {gs} must be a multiple of 16 and at most "
                         f"{MAX_SPLIT_ROWS}, dout {dout} a multiple of {MMA_WARP_COLS}")
    gps, splits = mma_plan_splits(din, dout, gs, _num_sms(x.device.index or 0))
    out = torch.empty((B, dout), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((splits, B, dout), dtype=torch.float32, device=x.device)
               if splits > 1 else out)
    lib = build.load("q4_mma")
    err = lib.q4_mma(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                     partial.data_ptr(), B, din, dout, gs, gps, splits,
                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "q4_mma")
    q4_mma.launches += 1
    return out


def q4_wgmma(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q4_gemv's function through the `q4_wgmma` kernel (wgmma over 128-row
    tiles), one launch per call: x bf16 of any row count, gs a multiple of
    16, dout a multiple of MMA_WARP_COLS, q and scale 16-byte aligned (x is
    copied where its rows are not); on a CPU tensor the plain version."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return q4_gemv_plain(x, q, scale)
    _check_cuda("q4_wgmma", x, q, scale, 16)
    M, din = x.shape
    dout = q.shape[1]
    gs = din // scale.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"q4_wgmma: x dtype {x.dtype}, not bfloat16")
    if M < 1:
        raise ValueError(f"q4_wgmma: {M} rows")
    if gs % 16 or gs > MAX_SPLIT_ROWS or dout % MMA_WARP_COLS:
        raise ValueError(f"q4_wgmma: group size {gs} must be a multiple of 16 and at most "
                         f"{MAX_SPLIT_ROWS}, dout {dout} a multiple of {MMA_WARP_COLS}")
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel copies x 16 bytes at a time; a new tensor is aligned
    gps, splits = wgmma_plan_splits(din, dout, gs, _num_sms(x.device.index or 0), M)
    out = torch.empty((M, dout), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((splits, M, dout), dtype=torch.float32, device=x.device)
               if splits > 1 else out)
    lib = build.load("q4_wgmma")
    err = lib.q4_wgmma(x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                       partial.data_ptr(), M, din, dout, gs, gps, splits,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "q4_wgmma")
    q4_wgmma.launches += 1
    return out


q4_gemv.launches = 0
q4_mma.launches = 0
q4_wgmma.launches = 0


class FrozenLinear(torch.autograd.Function):
    """x [..., din] @ a frozen quantized weight, differentiable in x only.
    The forward is `linear(x, q, scale)`: the kernel route on the card, the
    plain version on the CPU.  The backward is dX = dY @ dequant(q, scale,
    dY.dtype)^T by torch.matmul in dY's dtype, and no gradient for q or
    scale: the JAX package stops the gradient at a LoRA adapter's base
    (moshi_tpu/utils/matmul.py:47-52), and XLA computes that transpose
    outside any Pallas kernel there.  Without this Function a kernel's
    output, written through a raw pointer into a fresh tensor, would have
    no grad_fn, and the gradient through every frozen linear would be
    dropped on the card while the CPU's plain path kept it."""

    @staticmethod
    def forward(ctx, x, q, scale, linear, dequant):
        ctx.save_for_backward(q, scale)
        ctx.dequant = dequant
        return linear(x, q, scale)

    @staticmethod
    def backward(ctx, dy):
        q, scale = ctx.saved_tensors
        w = ctx.dequant(q, scale, dy.dtype)
        return torch.matmul(dy, w.transpose(-1, -2)), None, None, None, None


def frozen_linear(linear, dequant, x, q, scale):
    """`linear(x, q, scale)`, through FrozenLinear when autograd records
    and x requires grad; as it is otherwise (serving runs the same
    launches as without autograd)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return FrozenLinear.apply(x, q, scale, linear, dequant)
    return linear(x, q, scale)


def _q4_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-1]
    y = q4_gemv(x.reshape(math.prod(lead), x.shape[-1]).contiguous(), q, scale)
    return y.reshape(*lead, q.shape[-1])


def q4_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., din] @ a QTensor4 [din, dout] through q4_gemv; differentiable
    in x (FrozenLinear)."""
    return frozen_linear(_q4_linear, dequantize4, x, q, scale)
