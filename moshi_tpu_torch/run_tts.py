"""Text-to-speech over a checkpoint (counterpart of moshi_tpu/run_tts.py):
a JSONL script in, one wav per item out.

    python -m moshi_tpu_torch.run_tts --checkpoint-dir DIR [--device cuda] script.jsonl OUTDIR
    python -m moshi_tpu_torch.run_tts --checkpoint-dir DIR --text "hello" [--voice NAME] OUTDIR

A JSONL line is {"turns": [...]} or {"text": ...}, with "voices": voice
.safetensors files.  The simple mode (`--text`, `--voice`, each
repeatable) broadcasts texts against voices; a voice is a file, an
`hf://org/repo/name` on the hub, a name in `--voice-repo` (a local
directory or a hub repository, by default the JAX package's
kyutai/tts-voices), or `file://x.wav` for an audio-prefix model.  The items of a run are generated together, eagerly on `--device`;
draws come from a generator seeded 0.  `--debug-json` writes the JSONL
items' transcripts with their timings.
"""

import argparse
import json
from pathlib import Path

import torch

from . import audio
from .models.loaders import CheckpointInfo
from .models.tts import StateMachine, TokenIds, TTSModel

DEFAULT_DSM_TTS_VOICE_REPO = "kyutai/tts-voices"


def build_tts(checkpoint_dir: str | Path, temp: float = 0.6, cfg_coef: float = 1.0,
              n_q: int = 32, max_padding: int = 8, initial_padding: int = 2,
              voice_repo: str = DEFAULT_DSM_TTS_VOICE_REPO, device="cuda"):
    """build_tts_from_info over the checkpoint directory."""
    return build_tts_from_info(CheckpointInfo.from_dir(checkpoint_dir), temp=temp,
                               cfg_coef=cfg_coef, n_q=n_q, max_padding=max_padding,
                               initial_padding=initial_padding, voice_repo=voice_repo,
                               device=device)


def build_tts_from_info(info: CheckpointInfo, temp: float = 0.6, cfg_coef: float = 1.0,
                        n_q: int = 32, max_padding: int = 8, initial_padding: int = 2,
                        voice_repo: str = DEFAULT_DSM_TTS_VOICE_REPO,
                        voice_aliases: dict | None = None, device="cuda"):
    """(TTSModel, LM params, Mimi params, condition params or None) of a
    checkpoint, its weights on `device`: the text-audio delay, the machine's
    second stream and the speakers from `tts_config`, voice names resolved
    with the `model_id`'s suffix."""
    from .text.spm import SentencePieceTokenizer

    mimi, mimi_params = info.get_mimi(device=device)
    lm, lm_params = info.get_moshi(device=device)
    provider, fuser, cp_params = info.get_conditioners(lm.config.dim, device=device)
    tts_cfg = info.tts_config
    machine = StateMachine(TokenIds(card=lm.config.text_card + 1),
                           second_stream_ahead=tts_cfg.get("second_stream_ahead", 0),
                           max_padding=max_padding, initial_padding=initial_padding)
    # voice names resolve to "<name>.<sig>@<epoch>.safetensors"
    mid = info.model_id or {}
    voice_suffix = (f".{mid['sig']}@{mid['epoch']}.safetensors"
                    if "sig" in mid and "epoch" in mid else "")
    tts = TTSModel(lm, mimi, SentencePieceTokenizer(info.tokenizer_path), machine,
                   int(tts_cfg.get("audio_delay", 2.0) * mimi.config.frame_rate),
                   condition_provider=provider, fuser=fuser,
                   max_speakers=tts_cfg.get("max_speakers", 5), temp=temp, cfg_coef=cfg_coef,
                   n_q=n_q, voice_suffix=voice_suffix, voice_repo=voice_repo,
                   voice_aliases=voice_aliases)
    return tts, lm_params, mimi_params, cp_params


def _write(outdir: Path, pcms, sample_rate: int) -> list[Path]:
    outdir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, pcm in enumerate(pcms):
        path = outdir / f"tts-{i}.wav"
        audio.write_wav(path, pcm, sample_rate)
        print(f"wrote {path} ({pcm.shape[-1] / sample_rate:.1f}s)")
        paths.append(path)
    return paths


def main(argv=None) -> list[Path]:
    """The command line; returns the wavs written."""
    from .utils.serving import serving_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--temp", type=float, default=0.6)
    ap.add_argument("--cfg-coef", type=float, default=1.0)
    ap.add_argument("--n-q", type=int, default=32)
    ap.add_argument("--debug-json", default=None)
    ap.add_argument("--voice-repo", default=DEFAULT_DSM_TTS_VOICE_REPO)
    ap.add_argument("--text", action="append", default=None,
                    help="simple mode: a text to say (repeatable), broadcast against --voice")
    ap.add_argument("--voice", action="append", default=None,
                    help="simple mode: a voice name or path (repeatable)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("infile", nargs="?", default=None,
                    help='JSONL: one {"turns": [...]} or {"text": ...} per line')
    ap.add_argument("outdir")
    args = ap.parse_args(argv)

    device = serving_device(args.device)
    tts, lm_params, mimi_params, cp_params = build_tts(
        args.checkpoint_dir, args.temp, args.cfg_coef, args.n_q, voice_repo=args.voice_repo,
        device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    rate = tts.mimi.config.sample_rate
    if args.text is not None:
        texts = args.text if len(args.text) > 1 else args.text[0]
        voices = (args.voice if args.voice and len(args.voice) > 1
                  else (args.voice[0] if args.voice else ""))
        pcms = tts.simple_generate(lm_params, mimi_params, texts, voices,
                                   cfg_coef=args.cfg_coef, condition_params=cp_params,
                                   generator=generator)
        return _write(Path(args.outdir), pcms, rate)
    if args.infile is None:
        ap.error("either an infile or --text is required")

    entries_batch, attrs = [], []
    for line in Path(args.infile).read_text().splitlines():
        if not line.strip():
            continue
        item = json.loads(line)
        turns = item.get("turns") or [item["text"]]
        entries_batch.append(tts.prepare_script(turns, padding_between=1))
        voices = [tts.load_voice_embedding(v) for v in item.get("voices", [])]
        attrs.append(tts.make_condition_attributes(voices, None))
    conditioned = tts.condition_provider is not None and cp_params is not None
    result = tts.generate(lm_params, entries_batch, attributes=attrs if conditioned else None,
                          condition_params=cp_params, generator=generator)
    paths = _write(Path(args.outdir), tts.synthesize_pcm(lm_params, mimi_params, result), rate)
    if args.debug_json:
        Path(args.debug_json).write_text(json.dumps(
            {"transcripts": result.all_transcripts, "end_steps": result.end_steps,
             "consumption_times": result.all_consumption_times}, indent=2))
    return paths


if __name__ == "__main__":
    main()
