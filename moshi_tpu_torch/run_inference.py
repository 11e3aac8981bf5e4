"""Offline batched inference over a checkpoint (counterpart of
moshi_tpu/run_inference.py, `model_type` "moshi"): a wav file in, B
copies of it through Mimi encode -> LMGen.step -> Mimi decode, frame by
frame, the text printed as it comes and each copy's reply written as a wav.
The first frame is stepped twice, so that the model attends to the first
real codes and not only to the initial tokens.

    python -m moshi_tpu_torch.run_inference --checkpoint-dir DIR in.wav out.wav

The speech-to-text and hibiki branches are not ported yet (ROADMAP A.10,
A.12).
"""

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from . import audio
from .models.lm import UNGENERATED_TOKEN
from .models.lm_gen import LMGen, LMGenConfig


class InferenceState:
    def __init__(self, checkpoint_info, mimi, mimi_params, lm, lm_params, text_tokenizer,
                 batch_size: int, cfg_coef: float = 1.0, device="cuda", seed: int = 0,
                 **lm_gen_kwargs):
        if checkpoint_info.model_type != "moshi":
            raise NotImplementedError(
                f"model_type {checkpoint_info.model_type!r}: the speech-to-text and hibiki "
                "branches of run_inference are not ported yet (ROADMAP A.10, A.12)")
        self.mimi, self.mimi_params = mimi, mimi_params
        self.lm, self.lm_params = lm, lm_params
        self.text_tokenizer = text_tokenizer
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.mimi_dtype = mimi_params["quantizer"]["rvq_first"]["embedding"].dtype
        self.lm_gen = LMGen(lm, LMGenConfig.from_dict({**lm_gen_kwargs, "cfg_coef": cfg_coef}))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def run(self, in_pcms: np.ndarray, on_text=None, gen_seconds: float = 0.0,
            max_steps: int = 0) -> list[tuple[np.ndarray, np.ndarray]]:
        """in_pcms [B, 1, T] float32 -> per item (text tokens, pcm [1, T']).
        gen_seconds > 0 keeps generating that long past the input on
        silence; max_steps > 0 caps the steps."""
        B, fs, dev, md = self.batch_size, self.mimi.frame_size, self.device, self.mimi_dtype
        if gen_seconds > 0:
            pad = int(gen_seconds * self.mimi.config.sample_rate)
            in_pcms = np.pad(in_pcms, ((0, 0), (0, 0), (0, pad)))
        chunks = [in_pcms[:, :, i * fs:(i + 1) * fs] for i in range(in_pcms.shape[-1] // fs)]
        enc_state = self.mimi.init_encode_state(B, md, dev)
        dec_state = self.mimi.init_decode_state(B, md, dev)
        gen_state = self.lm_gen.init_state(B, self.generator, torch.bfloat16, dev)
        out_pcms, out_text = [[] for _ in range(B)], [[] for _ in range(B)]
        ntokens = 0
        t0 = time.time()
        for nsteps, chunk in enumerate(chunks, 1):
            if max_steps and nsteps > max_steps:
                break
            x = torch.as_tensor(np.array(chunk, np.float32), device=dev)
            codes, _ = self.mimi.encode_step(self.mimi_params, enc_state, x.to(md))
            if nsteps == 1:
                self.lm_gen.step(self.lm_params, gen_state, codes)
            out, _ = self.lm_gen.step(self.lm_params, gen_state, codes)
            out_np = out.cpu().numpy()
            if (out_np == UNGENERATED_TOKEN).any():
                continue
            ntokens += 1
            pcm, _ = self.mimi.decode_step(self.mimi_params, dec_state,
                                           out[:, 1:].clamp(min=0))
            pcm = pcm.float().cpu().numpy()
            for b in range(B):
                t = int(out_np[b, 0, 0])
                out_text[b].append(t)
                out_pcms[b].append(pcm[b])
                if b == 0 and on_text is not None and t not in (0, 3):
                    on_text(t)
        dt = time.time() - t0
        print(f"processed {ntokens} steps in {dt:.0f}s, {1000 * dt / max(ntokens, 1):.2f}ms/step")
        return [(np.asarray(t), np.concatenate(p, axis=-1) if p else np.zeros((1, 0), np.float32))
                for t, p in zip(out_text, out_pcms)]


def main(argv=None):
    from .models.loaders import CheckpointInfo
    from .text.spm import SentencePieceTokenizer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint-dir", required=True,
                    help="directory with config.json, the weights and the tokenizer")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--cfg-coef", type=float, default=1.0)
    ap.add_argument("--gen-seconds", type=float, default=0.0,
                    help="keep generating this long past the input")
    ap.add_argument("--max-steps", type=int, default=0, help="cap on the steps (0: none)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("infile")
    ap.add_argument("outfile", nargs="?", default="")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch sees no CUDA device")
    info = CheckpointInfo.from_dir(args.checkpoint_dir)
    mimi, mimi_params = info.get_mimi(device=device)
    lm, lm_params = info.get_moshi(device=device)
    tok = SentencePieceTokenizer(info.tokenizer_path)
    pcm, _ = audio.read_wav(args.infile, sample_rate=mimi.config.sample_rate)
    in_pcms = np.broadcast_to(pcm[None, :1], (args.batch_size, 1, pcm.shape[-1]))
    gen_cfg = dict(info.lm_gen_config)
    ckpt_cfg_coef = gen_cfg.pop("cfg_coef", 1.0)
    state = InferenceState(info, mimi, mimi_params, lm, lm_params, tok, args.batch_size,
                           args.cfg_coef if args.cfg_coef != 1.0 else ckpt_cfg_coef,
                           device=device, **gen_cfg)

    def on_text(t):
        print(tok.id_to_piece(t).replace("▁", " "), end="", flush=True)

    outs = state.run(np.ascontiguousarray(in_pcms), on_text=on_text,
                     gen_seconds=args.gen_seconds, max_steps=args.max_steps)
    print()
    if args.outfile:
        out_path = Path(args.outfile)
        for i, (_, pcm_out) in enumerate(outs):
            p = out_path if len(outs) == 1 else out_path.with_name(
                f"{out_path.stem}-{i}{out_path.suffix}")
            audio.write_wav(p, pcm_out[0], mimi.config.sample_rate)
            print(f"wrote {p} ({pcm_out.shape[-1] / mimi.config.sample_rate:.1f}s)")


if __name__ == "__main__":
    main()
