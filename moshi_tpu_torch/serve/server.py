"""The full-duplex frame engine of the server (counterpart of the
`ServerState` frame path in moshi_tpu/serve/server.py): per session, Mimi
encode -> LMGen.step -> Mimi decode on one 80 ms frame of PCM at a time.

The websocket/opus transport, the session queue, snapshots and the
migration vault are not ported yet; `main` serves sessions of PCM frames
made from a seed.

    python -m moshi_tpu_torch.serve.server --device cuda --sessions 2 --frames 20
"""

import argparse
import time

import numpy as np
import torch

from ..models.lm import UNGENERATED_TOKEN
from ..models.lm_gen import LMGen, LMGenConfig


class ServerState:
    """One model, one LMGen, B = 1 streaming state on `device`.  The codec
    runs in the dtype of its parameters; the KV cache is bf16, as in the
    JAX server."""

    def __init__(self, mimi, mimi_params, lm, lm_params, *, device="cpu",
                 rng_seed: int = 0, **lm_gen_kwargs):
        self.mimi, self.mimi_params = mimi, mimi_params
        self.lm, self.lm_params = lm, lm_params
        self.device = torch.device(device)
        self.mimi_dtype = mimi_params["quantizer"]["rvq_first"]["embedding"].dtype
        self.frame_size = mimi.frame_size
        self.lm_gen = LMGen(lm, LMGenConfig.from_dict(lm_gen_kwargs))
        self.session_seed = rng_seed
        self.session_tokens: list[np.ndarray] = []
        self.reset()

    def reset(self):
        """A fresh session: new streaming states and a generator seeded
        with `session_seed`."""
        dev = self.device
        self.enc_state = self.mimi.init_encode_state(1, self.mimi_dtype, dev)
        self.dec_state = self.mimi.init_decode_state(1, self.mimi_dtype, dev)
        generator = torch.Generator(device=dev)
        generator.manual_seed(self.session_seed)
        self.gen_state = self.lm_gen.init_state(1, generator, torch.bfloat16, dev)
        self.steps_done = 0
        self.session_tokens = []

    def warmup(self):
        """Run 4 zero frames through the whole path, then reset."""
        for _ in range(4):
            self.step_frame(np.zeros(self.frame_size, np.float32))
        self.reset()

    def step_frame(self, chunk: np.ndarray):
        """One 80 ms frame of PCM [frame_size] -> (pcm [frame_size] float32
        or None, text token or None).  Nothing is decoded while the LM's
        output is still UNGENERATED_TOKEN (the first max_delay frames)."""
        self.steps_done += 1
        x = torch.as_tensor(chunk, dtype=torch.float32).to(self.device)
        codes, _ = self.mimi.encode_step(self.mimi_params, self.enc_state,
                                         x.to(self.mimi_dtype)[None, None])
        out, _ = self.lm_gen.step(self.lm_params, self.gen_state, codes)
        out_np = out.cpu().numpy()
        if (out_np == UNGENERATED_TOKEN).any():
            return None, None
        self.session_tokens.append(out_np[0, :, 0])
        pcm, _ = self.mimi.decode_step(self.mimi_params, self.dec_state,
                                       out[:, 1:].clamp(min=0))
        return pcm[0, 0].float().cpu().numpy(), int(out_np[0, 0, 0])


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
