"""Text-only LM generation, the Helium runner (counterpart of
moshi_tpu/run_helium.py): a plain autoregressive text LM served by the same
transformer stack (no audio codebooks, no depformer).  The prompt is
prefilled in one chunk through the streaming state (the bf16 ring KV
cache); then each token is one step, the temporal forward of the last
token and its sampling.  On a CUDA device that step runs as replays of one
CUDA graph (utils/graphs.py), the generator registered with it, as the
JAX package jits it.

    python -m moshi_tpu_torch.run_helium --checkpoint-dir DIR --prompt "..." -n 100

DIR holds a text-only checkpoint: one that scripts/import_helium.py wrote
from a Hugging Face Llama-style model (PyTorch names, `model_type:
helium`), or a native one (q4 / int8 leaves) written by
models/native_ckpt.py, and a SentencePiece tokenizer.
"""

import argparse
import time

import torch

from .utils.graphs import GraphedStep
from .utils.sampling import sample_token


def generate_text(lm, params, prompt_ids: list[int], num_steps: int,
                  generator: torch.Generator, temp: float = 0.7, top_k: int = 50,
                  dtype=torch.bfloat16, graphed: bool | None = None,
                  stats: dict | None = None) -> list[int]:
    """num_steps tokens after prompt_ids: the first sampled from the
    prefill's last position, each next one from a step over the token
    before.  `graphed` (the default on a CUDA device) runs the first step
    eagerly (the warm-up), captures the second and replays the graph after;
    False runs every step eagerly (the CPU's only path).  `stats`, when
    given, receives the prefill's ms ("prefill_ms", up to the first token
    on the host) and each step's ("step_ms")."""
    c = lm.config
    assert c.n_q == 0 and c.dep_q == 0, "text-only LM expected"
    device = params["text_emb"]["weight"].device
    graphed = device.type == "cuda" if graphed is None else graphed
    if graphed and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    state = lm.transformer.init_state(1, dtype, device)
    prompt = torch.tensor(prompt_ids, dtype=torch.long, device=device)[None, None, :]

    def decode(token):
        """One step: token [1, 1, 1] in, the next one [1] out."""
        _, logits, _ = lm.forward_text_step(params, state, token)
        return sample_token(generator, logits[:, 0, 0], use_sampling=temp > 0, temp=temp,
                            top_k=top_k)

    # over a static token buffer; graphed, its output is the graph's static one
    step = GraphedStep(decode, graphed=graphed, device=device, generators=(generator,))
    token_in = torch.zeros((1, 1, 1), dtype=torch.long, device=device)

    t0 = time.perf_counter()
    _, logits, _ = lm.forward_text_step(params, state, prompt)
    token = sample_token(generator, logits[:, 0, -1], use_sampling=temp > 0, temp=temp,
                         top_k=top_k)
    out = [int(token[0])]
    step_ms = []
    prefill_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(num_steps - 1):
        t0 = time.perf_counter()
        token_in.copy_(token.view(1, 1, 1))
        token = step.warm_or_call(token_in)
        out.append(int(token[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if stats is not None:
        stats.update(prefill_ms=prefill_ms, step_ms=step_ms)
    return out


def main(argv=None, stats: dict | None = None) -> list[int]:
    """The CLI: prints the prompt and its completion and returns the
    completion's token ids (`stats` as generate_text's)."""
    from .models.loaders import CheckpointInfo
    from .text.spm import SentencePieceTokenizer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--prompt", default="Hello")
    ap.add_argument("-n", "--num-steps", type=int, default=100)
    ap.add_argument("--temp", type=float, default=0.7)
    ap.add_argument("--top-k", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch sees no CUDA device")
    info = CheckpointInfo.from_dir(args.checkpoint_dir)
    lm, params = info.get_moshi(device=device)
    tok = SentencePieceTokenizer(info.tokenizer_path)

    ids = tok.encode(args.prompt)
    generator = torch.Generator(device=device).manual_seed(0)
    out = generate_text(lm, params, ids, args.num_steps, generator, args.temp, args.top_k,
                        stats=stats)
    print(args.prompt + tok.decode(out))
    return out


if __name__ == "__main__":
    main()
