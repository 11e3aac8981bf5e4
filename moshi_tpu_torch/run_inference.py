"""Offline batched inference over a checkpoint (counterpart of
moshi_tpu/run_inference.py): a wav file in, B copies of it through Mimi
encode -> LMGen.step -> Mimi decode, frame by frame, the text printed as
it comes and each copy's reply written as a wav.  The first frame is
stepped twice, so that the model attends to the first real codes and not
only to the initial tokens.  By the checkpoint's `model_type`:

- "moshi": full duplex, as long as the input (and `--gen-seconds` of
  silence after it);
- "hibiki" (speech translation): the `description` conditioner's
  "very_good" rows (and "very_bad" ones under CFG) summed into the
  temporal input; after the input, one frame of all-`cardinality` codes
  (the end of the stream), then silence, until each stream samples the
  text EOS after that frame (or `--max-steps`);
- "stt" (speech-to-text, no depformer): the input padded with
  `stt_config`'s silence before (`audio_silence_prefix_seconds`) and after
  (`audio_delay_seconds` + 1 s); text only, of the first stream.

    python -m moshi_tpu_torch.run_inference --checkpoint-dir DIR in.wav out.wav
"""

import argparse
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from . import audio
from .conditioners import ConditionAttributes
from .models.lm import UNGENERATED_TOKEN
from .models.lm_gen import LMGen, LMGenConfig

SAMPLE_RATE = 24000  # stt_config's pads are in seconds of 24 kHz audio


def get_condition_attributes(model_type: str, batch_size: int, cfg_coef: float):
    """Hibiki's conditioning: a "very_good" description for each stream,
    then under CFG a "very_bad" one for each null row; None for the other
    model types."""
    if model_type != "hibiki":
        return None
    conditions = [ConditionAttributes(text={"description": "very_good"})
                  for _ in range(batch_size)]
    if cfg_coef != 1.0:
        conditions += [ConditionAttributes(text={"description": "very_bad"})
                       for _ in range(batch_size)]
    return conditions


class InferenceState:
    def __init__(self, checkpoint_info, mimi, mimi_params, lm, lm_params, text_tokenizer,
                 batch_size: int, cfg_coef: float = 1.0, condition_provider=None,
                 condition_provider_params=None, fuser=None, device="cuda", seed: int = 0,
                 **lm_gen_kwargs):
        self.info = checkpoint_info
        self.model_type = checkpoint_info.model_type
        if self.model_type not in ("moshi", "hibiki", "stt"):
            raise ValueError(f"model_type {self.model_type!r}")
        self.mimi, self.mimi_params = mimi, mimi_params
        self.lm, self.lm_params = lm, lm_params
        self.text_tokenizer = text_tokenizer
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.mimi_dtype = mimi_params["quantizer"]["rvq_first"]["embedding"].dtype
        self.lm_gen = LMGen(lm, LMGenConfig.from_dict({**lm_gen_kwargs, "cfg_coef": cfg_coef}))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.condition_sum = None
        attrs = get_condition_attributes(self.model_type, batch_size, cfg_coef)
        if attrs is not None and condition_provider is not None and fuser is not None:
            self.condition_sum = fuser.get_sum(condition_provider.prepare_and_provide(
                condition_provider_params, attrs))
        # what the last run did: loop steps, LMGen.step calls, output frames,
        # end-of-stream frames fed, ms per LMGen frame
        self.stats: dict = {}

    def run(self, in_pcms: np.ndarray, eos_id: int = 2, on_text=None,
            gen_seconds: float = 0.0, max_steps: int = 0) -> list[tuple[np.ndarray, np.ndarray]]:
        """in_pcms [B, 1, T] float32 -> per item (text tokens, pcm [1, T']);
        speech-to-text gives the first item's text and no PCM.  gen_seconds
        > 0 keeps generating that long past the input on silence; max_steps
        > 0 caps the steps (hibiki otherwise runs until every stream has
        sampled eos_id after the end-of-stream frame)."""
        B, fs, dev, md = self.batch_size, self.mimi.frame_size, self.device, self.mimi_dtype
        mimi, hibiki = self.mimi, self.model_type == "hibiki"
        if self.model_type == "stt":
            stt = self.info.stt_config
            pad_left = int(stt.get("audio_silence_prefix_seconds", 0.0) * SAMPLE_RATE)
            pad_right = int((stt.get("audio_delay_seconds", 0.0) + 1.0) * SAMPLE_RATE)
            in_pcms = np.pad(in_pcms, ((0, 0), (0, 0), (pad_left, pad_right)))
        if gen_seconds > 0:
            pad = int(gen_seconds * mimi.config.sample_rate)
            in_pcms = np.pad(in_pcms, ((0, 0), (0, 0), (0, pad)))
        chunks = deque(in_pcms[:, :, i * fs:(i + 1) * fs]
                       for i in range(in_pcms.shape[-1] // fs))
        enc_state = mimi.init_encode_state(B, md, dev)
        dec_state = mimi.init_decode_state(B, md, dev)
        gen_state = self.lm_gen.init_state(B, self.generator, torch.bfloat16, dev)
        has_audio = self.lm.config.dep_q > 0

        def encode(pcm):
            x = torch.as_tensor(np.array(pcm, np.float32), device=dev)
            return mimi.encode_step(self.mimi_params, enc_state, x.to(md))[0]

        def lm_step(codes):
            self.stats["lm_steps"] += 1
            return self.lm_gen.step(self.lm_params, gen_state, codes,
                                    condition_sum=self.condition_sum)[0]

        out_pcms, out_text = [[] for _ in range(B)], [[] for _ in range(B)]
        eos_reached = [False] * B
        need_eos_input = True
        self.stats = {"steps": 0, "lm_steps": 0, "tokens": 0, "eos_frames": 0, "step_ms": []}
        t0 = time.time()
        while not all(eos_reached):
            if max_steps and self.stats["steps"] >= max_steps:
                break
            ts = time.perf_counter()
            if chunks:
                codes = encode(chunks.popleft())
            elif hibiki and need_eos_input:
                need_eos_input = False
                self.stats["eos_frames"] += 1
                codes = torch.full((B, mimi.num_codebooks, 1), mimi.cardinality,
                                   dtype=torch.long, device=dev)
            elif hibiki:
                codes = encode(np.zeros((B, 1, fs), np.float32))
            else:
                break
            self.stats["steps"] += 1
            if self.stats["steps"] == 1:
                lm_step(codes)
            out = lm_step(codes)
            out_np = out.cpu().numpy()
            if (out_np == UNGENERATED_TOKEN).any():
                continue
            self.stats["tokens"] += 1
            if not has_audio:
                eos_reached = [not chunks] * B  # until the input is consumed
                t = int(out_np[0, 0, 0])
                out_text[0].append(t)
                if on_text is not None and t not in (0, 3):
                    on_text(t)
                self.stats["step_ms"].append(1000 * (time.perf_counter() - ts))
                continue
            pcm, _ = mimi.decode_step(self.mimi_params, dec_state, out[:, 1:].clamp(min=0))
            pcm = pcm.float().cpu().numpy()
            self.stats["step_ms"].append(1000 * (time.perf_counter() - ts))
            for b in range(B):
                if eos_reached[b]:
                    continue
                t = int(out_np[b, 0, 0])
                if t == eos_id and hibiki and not need_eos_input:
                    eos_reached[b] = True
                out_text[b].append(t)
                out_pcms[b].append(pcm[b])
                if b == 0 and on_text is not None and t not in (0, 3):
                    on_text(t)
        dt = time.time() - t0
        n = self.stats["tokens"]
        print(f"processed {n} steps in {dt:.0f}s, {1000 * dt / max(n, 1):.2f}ms/step")
        if not has_audio:
            return [(np.asarray(out_text[0]), np.zeros((1, 0), np.float32))]
        return [(np.asarray(t), np.concatenate(p, axis=-1) if p else np.zeros((1, 0), np.float32))
                for t, p in zip(out_text, out_pcms)]


def main(argv=None):
    """The CLI; returns the InferenceState (its `stats`) and the outputs."""
    from .models.loaders import CheckpointInfo
    from .text.spm import SentencePieceTokenizer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint-dir", required=True,
                    help="directory with config.json, the weights and the tokenizer")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--cfg-coef", type=float, default=1.0)
    ap.add_argument("--gen-seconds", type=float, default=0.0,
                    help="keep generating this long past the input")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="cap on the steps (0: none); hibiki otherwise runs until text EOS")
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
    # --cfg-coef overrides a cfg_coef stored in the checkpoint's lm_gen_config
    gen_cfg = dict(info.lm_gen_config)
    ckpt_cfg_coef = gen_cfg.pop("cfg_coef", 1.0)
    provider, fuser, cp_params = info.get_conditioners(lm.config.dim, device=device)
    state = InferenceState(info, mimi, mimi_params, lm, lm_params, tok, args.batch_size,
                           args.cfg_coef if args.cfg_coef != 1.0 else ckpt_cfg_coef,
                           condition_provider=provider, condition_provider_params=cp_params,
                           fuser=fuser, device=device, **gen_cfg)

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
    return state, outs


if __name__ == "__main__":
    main()
