"""Time design variants of the int4 flash-decode kernel on one NVIDIA GPU.

    python3 scripts/time_k4_variants.py [--parent DIR]

Each variant is moshi_tpu_torch/csrc/decode_attention_int4.cu with one
textual edit that takes back one choice of its design (VARIANTS says
which); "kernel_write" is the committed source launched with the write of
the layer's new column (the main path's launch), the others are launched
for the attention alone.  With --parent DIR (a checkout of an earlier
commit, e.g. unpacked from `git archive`), the decode_attention_int4.cu of
that checkout is timed too; its C entry must be the attention-only one of 9
pointers and 8 ints.  Sources and libraries go to build/k4_variants/
(gitignored).  Every variant is checked against the plain version at
Moshi's B = 16, H = 32, cap 3000 (the load-only diagnostic excepted; the
mask hides each slot's write lane, as on the main path) and timed with
chip_smoke.time_ms (CUDA-graph replay, operands cold in L2) at D = 128 and
64, in the listed order and again in reverse; ptxas registers and spills
and the card's name and power limit are printed.
"""

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from moshi_tpu_torch.ops import build, int4_attention as i4  # noqa: E402

OUT = ROOT / "build" / "k4_variants"
# 24 layers: the 20 calls of a timing cycle read and write 20 distinct
# layers, as a frame does, so the written sectors go back to memory (over
# 2 layers they stay dirty in L2 between calls and the write looks 3x cheaper)
B, H, CAP, LAYERS = 16, 32, 3000, 24

LOOP = """  for (int c = warp; c < nchunks; c += warps) {
    Scores<D> kpart;
    Values<D> vpart;
    load_scores(c * kChunk, kpart);
    load_values(c * kChunk, vpart);
    uint32_t pb[kTiles][2];
    softmax(kpart, pb);
    pv(vpart, pb);
  }"""
V_AFTER = """  for (int c = warp; c < nchunks; c += warps) {
    Scores<D> kpart;
    load_scores(c * kChunk, kpart);
    uint32_t pb[kTiles][2];
    softmax(kpart, pb);
    Values<D> vpart;
    load_values(c * kChunk, vpart);
    pv(vpart, pb);
  }"""
AHEAD = """  Scores<D> nk;
  Values<D> nv;
  if (warp < nchunks) {
    load_scores(warp * kChunk, nk);
    load_values(warp * kChunk, nv);
  }
  for (int c = warp; c < nchunks; c += warps) {
    const Scores<D> kpart = nk;
    const Values<D> vpart = nv;
    if (c + warps < nchunks) {
      load_scores((c + warps) * kChunk, nk);
      load_values((c + warps) * kChunk, nv);
    }
    uint32_t pb[kTiles][2];
    softmax(kpart, pb);
    pv(vpart, pb);
  }"""
LOADS_ONLY = """  uint32_t sink = 0;
  for (int c = warp; c < nchunks; c += warps) {
    Scores<D> kpart;
    Values<D> vpart;
    load_scores(c * kChunk, kpart);
    load_values(c * kChunk, vpart);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int w = 0; w < kW / 4; ++w) sink ^= kpart.k[i][w];
#pragma unroll
    for (int i = 0; i < D / 16; ++i)
#pragma unroll
      for (int w = 0; w < kW / 2; ++w) sink ^= vpart.v[i][w];
#pragma unroll
    for (int w = 0; w < kW / 2; ++w) sink ^= kpart.ks[w] ^ kpart.vs[w];
    sink ^= kpart.valid;
  }
  if (sink == 0x12345678u) acc[0][0] = 1.f;"""
BYTE_STORE = """    dst[static_cast<size_t>(kC / 2 * lane + r) * cap_pad] =
        static_cast<int8_t>(((hi & 15) << 4) | (lo & 15));"""
SCALE_STORE = "  if (lane == scale_lane) *scale_dst = __float2bfloat16_rn(scale);"
V_WRITE = """    store_column<D>(vv + static_cast<size_t>(blockIdx.y) * vv_stride + blockIdx.x * D,
                    v_w + rows_off, vs_w + scale_off, cap_pad, lane, scale_lane);"""
POST_LOOP_WRITE = """  if (pos != nullptr) {
    const int64_t p = pos[blockIdx.y];
    if (p >= 0 && p < cap_pad && warp == static_cast<int>(p / kChunk) % warps)
      write_lane(static_cast<int>(p));
  }
"""
IN_LOOP_WRITE = """    if (pos != nullptr && pos[blockIdx.y] >= 0 && pos[blockIdx.y] < cap_pad &&
        c == pos[blockIdx.y] / kChunk)
      write_lane(static_cast<int>(pos[blockIdx.y]));
"""
CAP_REGS = ("__launch_bounds__(32 * kMaxWarps, 2)", "__launch_bounds__(32 * kMaxWarps)")
# name -> (what the edit takes back, [(old, new), ...])
VARIANTS = {
    "kernel": ("the committed source", []),
    "kernel_write": ("the committed source, launched with the layer's cache write", []),
    "rows_32B": ("32 bytes of a row per warp load (chunks of 32 positions)",
                 [("constexpr int kW = 8;", "constexpr int kW = 4;")]),
    "rows_128B": ("128 bytes of a row per warp load (chunks of 128 positions)",
                  [("constexpr int kW = 8;", "constexpr int kW = 16;")]),
    "no_l2_prefetch": ("no .L2::256B prefetch on the loads", [(".L2::256B", "")]),
    "mask_bytes": ("the mask read a byte at a time",
                   [("if (mask_words && n == kW) {", "if (false) {")]),
    "v_after_scores": ("V loaded after the scores are taken", [(LOOP, V_AFTER)]),
    "next_chunk_ahead": ("the next chunk loaded into registers before this one's arithmetic",
                         [(LOOP, AHEAD)]),
    "no_register_cap": ("no cap of 128 registers (launch bounds without a minimum of 2 "
                        "blocks)", [CAP_REGS]),
    "loads_only": ("diagnostic: the kernel's loads with no arithmetic", [(LOOP, LOADS_ONLY)]),
    # diagnostics of the write (launched with it): what it costs, by part
    "write_in_loop": ("the write stored right after w*'s step on the lane's chunk, when its "
                      "sectors were just loaded into L2 (not after the loop)",
                      [(POST_LOOP_WRITE, ""), (LOOP, LOOP.replace("    pv(vpart, pb);\n",
                                                                  "    pv(vpart, pb);\n"
                                                                  + IN_LOOP_WRITE))]),
    "write_no_stores": ("diagnostic: the write's loads and quantization, no stores",
                        [(BYTE_STORE, "    if (cap_pad < 0) {\n" + BYTE_STORE + "\n    }"),
                         (SCALE_STORE, SCALE_STORE.replace("lane == scale_lane",
                                                           "cap_pad < 0"))]),
    "write_k_only": ("diagnostic: the write of the K column alone", [(V_WRITE, "")]),
    "write_streaming": ("the write's byte stores marked streaming (st.global.cs)",
                        [(BYTE_STORE, """    asm volatile("st.global.cs.b8 [%0], %1;" ::
                 "l"(dst + static_cast<size_t>(kC / 2 * lane + r) * cap_pad),
                 "r"(((hi & 15) << 4) | (lo & 15)));""")]),
    "write_through": ("the write's byte stores written through to memory (st.global.wt)",
                      [(BYTE_STORE, """    asm volatile("st.global.wt.b8 [%0], %1;" ::
                 "l"(dst + static_cast<size_t>(kC / 2 * lane + r) * cap_pad),
                 "r"(((hi & 15) << 4) | (lo & 15)));""")]),
}
PARENT_VARIANTS = {"parent": ("the parent's kernel", [])}


def edited(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant edit does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(sources: dict) -> dict:
    """One nvcc per variant, all at once; returns name -> (entry, registers)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", f"-I{build.CSRC}", "-o",
               str(OUT / f"{name}.so"), str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        _, spills = cs.ptxas_summary(log)
        fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), "decode_attention_int4")
        fn.argtypes = (build.SIGNATURES["decode_attention_int4"] if not name.startswith("parent")
                       else [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        entries[name] = fn
        print(f"[variants] {name}: registers per instance {regs}, {spills} bytes of spill "
              f"stores", flush=True)
    return entries


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="checkout whose kernel is timed beside")
    ap.add_argument("--only", nargs="+", metavar="NAME", help="time these variants alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k4_variants.py: torch sees no CUDA device")
    src = (build.CSRC / "decode_attention_int4.cu").read_text()
    table = {name: (what, edited(src, edits)) for name, (what, edits) in VARIANTS.items()}
    if args.parent:
        parent = (args.parent / "moshi_tpu_torch" / "csrc" / "decode_attention_int4.cu").read_text()
        table.update({name: (what, edited(parent, edits))
                      for name, (what, edits) in PARENT_VARIANTS.items()})
    if args.only:
        table = {name: table[name] for name in args.only}
    for name, (what, _) in table.items():
        print(f"[variants] {name}: {what}", flush=True)
    entries = build_variants({name: text for name, (_, text) in table.items()})

    dev = torch.device("cuda", 0)
    print(f"[variants] card: {cs.card_line()}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warps = i4.plan_warps(B, H, H, CAP, sms)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    cap_pad = -(-CAP // 128) * 128
    for D in (128, 64):
        caches = cs.random_int4_cache(g, LAYERS, B, H, D, cap_pad, dev)
        q = torch.randn(B, H, 1, D, device=dev, generator=g).to(torch.bfloat16)
        pos = torch.randint(0, CAP, (B,), device=dev, generator=g)
        mask = torch.rand(B, CAP, device=dev, generator=g) < 0.9
        mask[torch.arange(B, device=dev), pos] = False
        kk, vv = cs.main_path_rows(g, B, H, D, dev)
        ref = i4.decode_attention_int4_stats_plain(q, 1, *caches, mask)
        outs = (torch.empty(B, H, D, device=dev), torch.empty(B, H, 1, device=dev),
                torch.empty(B, H, 1, device=dev))

        def launcher(name):
            fn = entries[name]
            rows, strides = (), ()
            if not name.startswith("parent"):
                rows = ((kk.data_ptr(), vv.data_ptr(), pos.data_ptr()) if "write" in name
                        else (None, None, None))
                strides = (kk.stride(0), vv.stride(0))

            def call(q_, layer, k, v, ks, vs, m_):
                err = fn(q_.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(),
                         m_.data_ptr(), *rows, *(o.data_ptr() for o in outs), layer, B, H, H, D,
                         CAP, cap_pad, warps, *strides, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            return call
        ops = [(q, li, *caches, mask) for li in range(LAYERS)]
        launcher("kernel")(*ops[0])            # a warm-up before the first timing
        cs.time_ms(launcher("kernel"), ops)
        for name in [*table, *reversed(table)]:
            call = launcher(name)
            call(*ops[1])
            torch.cuda.synchronize()
            if name in ("loads_only", "write_no_stores", "write_k_only"):
                check = "not checked (a diagnostic)"
            else:
                err = max(cs.rel_err(outs[0] / outs[2], ref[0] / ref[2]),
                          cs.rel_err(outs[1], ref[1]))
                if not err <= cs.ATTN_BOUND:
                    raise RuntimeError(f"{name} disagrees with the plain version: {err:.3e}")
                check = f"max rel err {err:.2e}"
            ms = cs.time_ms(call, ops)
            print(f"[variants] D={D} {name}: {ms:.4f} ms ({check})", flush=True)
        del caches, ops
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
