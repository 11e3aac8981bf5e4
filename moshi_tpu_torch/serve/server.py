"""The full-duplex frame engine of the server (counterpart of the
`ServerState` frame path in moshi_tpu/serve/server.py): per session, Mimi
encode -> LMGen.step -> Mimi decode on one 80 ms frame of PCM at a time.

The websocket/opus transport, the session queue, snapshots and the
migration vault are not ported yet; `main` serves sessions of PCM frames
made from a seed (each frame as CUDA-graph replays on a CUDA device).

    python -m moshi_tpu_torch.serve.server --device cuda --sessions 2 --frames 20
"""

import argparse
import time

import numpy as np
import torch

from ..models.lm import UNGENERATED_TOKEN
from ..models.lm_gen import LMGen, LMGenConfig
from ..utils.graphs import GraphedStep
from ..utils.trees import copy_into


class ServerState:
    """One model, one LMGen, B = 1 streaming state on `device`.  The codec
    runs in the dtype of its parameters; the KV cache is bf16, as in the
    JAX server.

    The frame runs as the JAX server's three programs: Mimi encode,
    LMGen.step, and Mimi decode (skipped while the LM's output is still
    UNGENERATED_TOKEN).  `graphed` (the default on a CUDA device) captures
    each as a CUDA graph at its first frame after `warmup()` and replays
    it at every frame after; the state, the generator and the PCM input
    buffer are allocated once and written in place.  `graphed=False` runs
    the same functions eagerly (the CPU's only path)."""

    def __init__(self, mimi, mimi_params, lm, lm_params, *, device="cuda",
                 rng_seed: int = 0, graphed: bool | None = None, **lm_gen_kwargs):
        self.mimi, self.mimi_params = mimi, mimi_params
        self.lm, self.lm_params = lm, lm_params
        self.device = dev = torch.device(device)
        self.graphed = dev.type == "cuda" if graphed is None else graphed
        if self.graphed and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        self.mimi_dtype = md = mimi_params["quantizer"]["rvq_first"]["embedding"].dtype
        self.frame_size = mimi.frame_size
        self.lm_gen = LMGen(lm, LMGenConfig.from_dict(lm_gen_kwargs))
        self.session_seed = rng_seed
        self.generator = torch.Generator(device=dev)
        self.enc_state = mimi.init_encode_state(1, md, dev)
        self.dec_state = mimi.init_decode_state(1, md, dev)
        self.gen_state = self.lm_gen.init_state(1, self.generator, torch.bfloat16, dev)
        self.pcm_in = torch.zeros(self.frame_size, dtype=torch.float32, device=dev)
        self.encode = GraphedStep(self._encode, graphed=self.graphed, device=dev)
        self.step = GraphedStep(self._step, graphed=self.graphed, device=dev,
                                generators=(self.generator,))
        self.decode = GraphedStep(self._decode, graphed=self.graphed, device=dev)
        self.session_tokens: list[np.ndarray] = []
        self.reset()

    def _encode(self, pcm):
        codes, _ = self.mimi.encode_step(self.mimi_params, self.enc_state,
                                         pcm.to(self.mimi_dtype)[None, None])
        return codes

    def _step(self, codes):
        out, _ = self.lm_gen.step(self.lm_params, self.gen_state, codes)
        return out

    def _decode(self, out):
        pcm, _ = self.mimi.decode_step(self.mimi_params, self.dec_state,
                                       out[:, 1:].clamp(min=0))
        return pcm[0, 0].float()

    def reset(self):
        """A fresh session: the streaming states rewritten in place with the
        values of new ones, the generator reseeded with `session_seed`.  No
        tensor moves, so captured graphs stay valid."""
        dev, md = self.device, self.mimi_dtype
        copy_into(self.enc_state, self.mimi.init_encode_state(1, md, dev))
        copy_into(self.dec_state, self.mimi.init_decode_state(1, md, dev))
        copy_into(self.gen_state, self.lm_gen.init_state(1, None, torch.bfloat16, dev))
        self.generator.manual_seed(self.session_seed)
        self.steps_done = 0
        self.session_tokens = []

    def warmup(self):
        """Run zero frames eagerly through the whole path (decode included:
        max_delay + 2 frames, at least 4), on the graphs' side streams when
        graphed, then reset.  A graphed engine needs it before its first
        frame."""
        for _ in range(max(4, self.lm.config.max_delay + 2)):
            self._frame(np.zeros(self.frame_size, np.float32), warm=True)
        self.reset()

    def step_frame(self, chunk: np.ndarray):
        """One 80 ms frame of PCM [frame_size] -> (pcm [frame_size] float32
        or None, text token or None).  Nothing is decoded while the LM's
        output is still UNGENERATED_TOKEN (the first max_delay frames)."""
        return self._frame(chunk, warm=False)

    def _frame(self, chunk, warm: bool):
        def run(step, *args):
            return step.warm_up(*args) if warm else step(*args)

        self.steps_done += 1
        self.pcm_in.copy_(torch.as_tensor(chunk, dtype=torch.float32))
        out = run(self.step, run(self.encode, self.pcm_in))
        out_np = out.cpu().numpy()
        if (out_np == UNGENERATED_TOKEN).any():
            return None, None
        self.session_tokens.append(out_np[0, :, 0])
        pcm = run(self.decode, out)
        return pcm.cpu().numpy(), int(out_np[0, 0, 0])


def serve_sessions(state: ServerState, seeds, frames: int):
    """Serve one session per seed, each of `frames` frames of noise PCM
    drawn from that seed and sampled with a generator of that seed.
    Returns, per session, (tokens [generated frames, 1 + dep_q], pcm
    frames, ms per frame)."""
    results = []
    for seed in seeds:
        pcm = (0.1 * np.random.RandomState(seed).randn(frames, state.frame_size)
               ).astype(np.float32)
        state.session_seed = seed
        state.reset()
        audio, ms = [], []
        for f in range(frames):
            t0 = time.perf_counter()
            out_pcm, _ = state.step_frame(pcm[f])
            ms.append((time.perf_counter() - t0) * 1e3)
            if out_pcm is not None:
                audio.append(out_pcm)
        width = 1 + state.lm.config.dep_q
        tokens = np.array(state.session_tokens, dtype=np.int64).reshape(-1, width)
        results.append((tokens, audio, ms))
    return results


def main(argv=None):
    from ..models.lm import LMModel, lm_config_v0_1
    from ..models.mimi import MimiModel, mimi_v0_1_config
    from ..utils.quantize import quantize_lm_params

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sessions", type=int, default=2)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = lm_config_v0_1()
    lm = LMModel(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    lm_params = quantize_lm_params(lm.init_params(gen, torch.bfloat16, dev), mode="int4")
    mimi = MimiModel(mimi_v0_1_config(cfg.dep_q))
    mimi_params = mimi.init_params(gen, torch.bfloat16, dev)
    state = ServerState(mimi, mimi_params, lm, lm_params, device=dev, rng_seed=args.seed)
    state.warmup()
    seeds = range(args.seed, args.seed + args.sessions)
    for i, (tokens, _, ms) in enumerate(serve_sessions(state, seeds, args.frames)):
        print(f"session {i}: {len(tokens)} text tokens, "
              f"p50 {np.percentile(ms, 50):.2f} ms/frame on {dev}")


if __name__ == "__main__":
    main()
