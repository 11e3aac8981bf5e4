"""Smoke run of the PyTorch/CUDA port (moshi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. device  - the card's name and `nvidia-smi` name/power limit; fails at
               once when torch sees no CUDA device;
  2. build   - nvcc builds every kernel from moshi_tpu_torch/csrc/ into
               build/kernels/, one nvcc per source, all at once (skipped
               when a library of the same sources is already there), and
               prints each library's registers and spills (-Xptxas -v; a
               spill fails the run);
  3. kernels - each kernel against its plain PyTorch version on the card at
               the main paths' shapes: the q4_gemv and int8_gemv kernels at
               B = 1, 4, 9, 16 in bf16 and f32 (their timed lines name the
               launch plan: columns a lane, warps, cluster, rows a block),
               q4_mma at B = 2, 4, 9, 16
               and int8_mma at B = 1, 2, 4, 9, 16 in bf16,
               decode_attention_int4 at B = 16, H = 32, D = 128 and
               64 with its plan (warps, blocks per SM), a ragged mask and
               one with a slot of positions 0..99 only and a fully masked
               slot, timed at both head dims; decode_attention_int4_write
               (the same launch also writing the layer's new column, which
               replaces cache_write_int4) at L = 32, B = 16, D = 128 and
               64 over two frames of the ring (lanes 0, 63, 64, cap - 1, a
               frozen slot, a fully masked one), every cache byte against
               the plain write, deterministic, timed beside the attention
               alone,
               decode_attention_int8 at the ASR path's B = 256, H = 8, cap
               750 and Moshi's B = 16, H = 32, cap 3000, D = 128 and 64, a
               ragged mask and a slot with every position masked (at
               Moshi's shape also a mask of positions 0..99 only), with
               its plan (splits, cluster, warps, blocks per SM); then
               CUDA-graph-replay times (operands cold in L2) of each kernel,
               its plain version and one PyTorch library call for the same
               work, beside the least time the card could take (bound); the
               two q4 kernels and the two int8 kernels at B = 1, 2, 4, 8, 16
               (their crossovers); one launch's floor (int8_mma and
               torch.matmul at 16 x 64, beside a one-element add_); at the
               tts path's shapes (B = 16): every int8 linear of the frame on
               the kernel its route takes (int8_mma, or int8_gemv for the
               heads of 32001 and 2049 columns), the fused
               decode_attention_int4 launch at L = 48, H = 32, D = 64, cap
               1000 with its plan, and decode_attention_int8 at H = 32,
               cap 1000, D = 64, each checked and timed as above; q4_wgmma
               above a decoding batch, at M = 32, 64, 256 and 512 rows at the
               five q4 shapes (checked, timed beside the plain version,
               torch.matmul on the bf16 weight and the bound, with TFLOP/s,
               summed over one offline forward's 129 launches; M = 16 too,
               beside q4_mma, for the crossover only), and the f32 route
               (the q4_gemv kernel in 16-row chunks) at M = 40; at
               Hibiki-2B's shapes (the five q4 ones of a 2560-wide model
               with a 7040 hidden size and a 48000-column head, and
               depformer_in 2560 -> 1024) at 1 and 4 rows, each on the
               kernel its route takes, checked and timed as above, summed
               over one LMGen.step's launches; int8_wgmma above 16 rows at
               the depformer's shapes (one launch a call: checked at M =
               17, 33, 63-65, 127-129, 200 and 512, timed at 17, 32, 64 and
               512 beside the 16-row int8_mma chunks it replaced) and
               int8_linear under autograd at 512 rows (one int8_wgmma
               launch) against the plain path (output and dX); q4_wgmma at
               Helium-1 2B's 203-row prefill at its five q4 shapes, checked
               and timed as above, summed over the prefill's 97 launches;
  4. slice   - Moshi-7B shapes with q4 temporal weights and an int8
               depformer, bf16 KV cache, bf16 Mimi, all initialised from a
               seed on the card; the graphed ServerState: warm-up, then 3
               sessions of 40 frames of seeded PCM with sampling on
               (sessions 1 and 3 share a seed), each frame replays of the
               three graphs (encode, LMGen.step, decode) captured at its
               first frame.  Checks PCM, token ranges, that sessions 1 and 3
               agree and 1 and 2 do not, that the captured step's kernel
               launches are exactly what the config implies per
               LMGen.step (the q4 linears on the q4_gemv kernel at B = 1,
               the int8 ones on int8_mma) and the replay counts; prints
               p50/p90 ms per frame, a profiler pass over 5 graphed frames
               (card busy ms, idle share, device ops per frame), then one
               session of the eager path (p50/p90, a launch count per
               frame, whether its sampled tokens equal the graphed ones);
 4b. serve   - the server's entry point over a checkpoint on disk: the same
               weights written with the port's save_params (a native q4
               checkpoint: config.json with a greedy lm_gen_config, Mimi,
               a synthetic 32000-piece tokenizer) into build/, loaded back
               by load_state as `main` loads it (bytes, seconds, GB/s), every
               leaf torch.equal to the written one; the aiohttp app on
               127.0.0.1, warmed up as `main` warms it, and raw-PCM clients
               (MT 10) of 40 frames each: session 1 greedy, whose tokens must
               equal those of a ServerState on the in-memory weights fed the
               same PCM, sessions 2 and 3 sampled with one text_seed (equal
               messages) and 4 with another (not equal), and a second client
               that connects during session 1 and must get MT 4 queue
               positions, then its session; the launches of the first
               captured step exactly the slice's per step, and of the whole
               phase that times 1 + 2 x 3 (two override sets, each warmed
               twice and captured); p50/p90 ms from a frame sent to its PCM
               reply, beside [slice]'s p50; the directory stays for
               [worker];
  5. batched - the same weights with the int4 KV cache, B = 16 slots of
               BatchedMoshiState, each frame one replay of the graph
               captured at its first frame: a greedy run of 40 frames whose
               slots must agree token for token (two slots with one PCM, a
               slot that joins 5 frames late, one frozen for frames 10-14,
               one reset at frame 20 that replays the PCM from the start),
               run graphed and eagerly, whose tokens, PCM and every state
               byte must be equal; then a sampled run of 40 graphed frames
               on all 16 slots (p50/p75/p90 ms per batched frame, peak
               memory) and 10 eager ones; launch counts of the kernels (the
               q4 linears on q4_mma and the int8 ones on int8_mma at
               B = 16, 32 decode_attention_int4 launches, each writing its
               layer's column) exact per captured frame and per eager
               frame; a torch.profiler pass over 5 graphed frames for the
               card's busy time; then the greedy runs once more with the
               int8 KV cache (32 decode_attention_int8 per frame), 5 frames
               of every slot graphed and eager, and a profiler pass over 5
               graphed ones;
  6. offline - the offline halves on the same weights: Mimi v0.1's encode
               and decode in f32 (the bf16 weights cast up) and in bf16,
               over B = 4 x 50 frames of seeded PCM and one input 1000
               samples longer, against encode_step / decode_step from a
               fresh state (the share of equal codes, the decoded PCM's
               relative error, each held to OFFLINE_BOUNDS; ms and seconds
               of audio per second); then Moshi-7B's LMModel.forward over
               seeded codes [2, 17, 128]: exactly 129 q4_wgmma launches
               of 256 rows and no other GEMV, finite logits and masks equal
               to the plain ones, forward_text's text logits against 128
               forward_text_step over the bf16 ring KV (relative error,
               greedy argmax agreement), p50 of 5 calls, scored frames per
               second and a profiler pass (card busy ms, q4_wgmma's
               share);
 6a. train   - training on the same weights, eager: (a) rank-128 f32
               LoRA adapters on every linear, lora_optimizer(make_optimizer),
               seeded codes [2, 17, 256] repeated: the step-0 gradient of
               every adapter with the kernels against the plain GEMVs in f32
               (bound TRAIN_WITNESS_BOUND; the bf16 plain GEMVs' reading and
               the one with every base's backward dropped beside it, the
               latter above the bound), the same step with remat (equal,
               128 recomputed q4_wgmma), then 6 steps: exactly 129 q4_wgmma
               a step, s/step, frames/s, peak GiB, the frozen leaves byte for
               byte, the loss falling; (b) LMGen at B = 1 over the trained
               tree, 8 eager frames of exactly 129 q4_gemv and 208 int8_mma,
               and the fused bf16 tree's text logits against the LoRA tree's;
               (a2) the same as (a) over int8 serving weights cut to 8 layers
               (33 int8_wgmma a step, one launch of 512 rows each), 2 steps;
               (c) Mimi v0.1 in f32 through `python -m moshi_tpu_torch.train`
               (two subprocesses with --deterministic: 20 steps saved at 10,
               then a resume from 10), the loss at steps 1 and 20, entropy,
               the synced codec's codes, the resumed final loss; (d) (a2)'s
               tree as a native checkpoint trained by two ranks sharing the
               one card (two processes on cuda:0 in a gloo group, which moves
               the collectives' CUDA tensors through host memory; NCCL
               refuses two ranks on one device), mesh {dp: 2} and then
               {dp: 2, fsdp: true}: the step-0 loss and all-reduced adapter
               gradient against (a2)'s one-rank step on the global batch
               (bound TRAIN_MESH_BOUND) and against the same step taken as
               two one-row halves (TRAIN_MESH_SPLIT_BOUND), then 2 steps
               through run_training:
               exactly 33 int8_wgmma of 256 rows per rank a step, s/step,
               each rank's peak GiB in the steps and resident GiB of params
               and optimizer state between steps; (e) the same checkpoint
               through `torchrun --nproc_per_node 1 -m moshi_tpu_torch.train`
               with mesh {dp: 1} (NCCL, world size 1) and through the plain
               CLI without a mesh, 2 steps each with --deterministic: the
               saved params equal byte for byte; the checkpoint is deleted;
 6b. hibiki  - speech translation at the full width of s2s_2b_16rvq_202501
               with a Hibiki checkpoint's depformer fields (16 steps on 9
               weight sets, rank-128 depformer embeddings) and a
               `description` LUT, q4 temporal linears and head, an int8
               depformer, bf16 ring KV at ctx 3000, a bf16 Mimi with 16
               codebooks, from a seed, written as a native checkpoint and
               run through run_inference.main (the CLI): run (a) B = 1
               twice (equal tokens), run (b) B = 2 at cfg_coef 3.0 (4 model
               rows), each over 3 s of seeded PCM, the end-of-stream frame
               and silence, greedy, to 60 steps; launches exactly 97 q4 and
               416 int8 per LMGen.step (q4_gemv at B = 1, q4_mma at 4 rows;
               int8_mma), the end-of-stream frame fed once, PCM of as many
               frames as text tokens, finite, EOS's embedding PAD's;
               ms/step p50/p90, peak memory; then the plain witness: run
               (a)'s first 8 temporal steps with the kernels against the
               same inputs through the plain GEMVs, the text logits held
               to HIBIKI_WITNESS_BOUND; the checkpoint is deleted;
 6c. helium  - text generation at the full width of Helium-1 preview 2B
               (dim 2560, 24 layers, 20 heads of 128, FFN 7040, text card
               48000, context 4096), q4 on its 96 layer linears and head,
               from a seed, written as a native checkpoint (model_type
               helium, a synthetic 48000-piece tokenizer) and run through
               run_helium over a 203-token prompt (a multiple of neither 16
               nor 128): (a) main greedy, graphed, 128 tokens, twice (equal
               tokens); (b) generate_text eagerly over the same ids (the
               graphed tokens); each run's forward_text_step calls: the
               prefill's 97 q4_wgmma launches of 203 rows, 97 q4_gemv in
               each decode step that launches (graphed: the warm-up and the
               capture, the rest replays), nothing else; the plain witness
               (the prefill's last logits against the plain GEMVs in f32,
               HELIUM_WITNESS_BOUND); (c) main at its sampling defaults
               twice (equal tokens); prefill ms, ms/token p50/p90 graphed
               and eager, tokens/s, peak GiB, a profiler pass over an eager
               run (q4_gemv's card ms a step); the checkpoint is deleted;
 6d. bench_cli - moshi_tpu_torch.benchmark.main in-process: --mimi-only
               (100 steps), --mode duplex --model moshi_7b_int4 (60 paced
               steps, f32 Mimi, three graphs: [slice]'s 129 q4_gemv + 208
               int8_mma at the warm-up step and at the capture, nothing
               while replaying; its p50 beside [slice]'s) and --mode asr
               --batch 64 --kv-cache int8 --mimi-dtype bf16 (30 steps, 16
               decode_attention_int8 in each warm-up frame and the capture,
               the host-only part merged in); each printed JSON's keys the
               JAX function's;
 6d. configs - the options the other phases do not run: (a) after
               [offline], on its q4 weights, Moshi-7B's temporal
               transformer and text head at B = 2 over the model-dtype,
               int8 and int4 KV caches at ctx 3000 in turn: 8 steps of
               T = 1, one of T = 64 (exactly 129 q4_wgmma of 128 rows and
               nothing else; host ms, peak GiB), 8 of T = 1, against 80
               steps of T = 1, the last 8 steps' text logits held to
               HIBIKI_WITNESS_BOUND; (c) Mimi at v0.1's widths in f32 with
               replicate padding, shortcut convs and a gelu-gated
               transformer of d_model 1024 between its 512-wide ends, held
               to OFFLINE_BOUNDS["f32"] as [offline] holds Mimi v0.1; (b)
               inside [tts], on its weights, batched TTS at 32 model rows:
               B = 32 slots, then B = 16 under true CFG 3.0 on the model
               built without its `cfg` condition, 10 greedy frames graphed
               and 5 eager each, equal in tokens, PCM and every state byte,
               launches 688 int8_wgmma, 2 x 17 int8_gemv (the heads' 16-row
               chunks) and 48 fused decode_attention_int4 a frame, p50 / p90
               ms; [kernels] times the frame's int8 linears at 32 rows on
               that route, int8_wgmma beside the int8_mma chunks;
  7. asr     - batched speech-to-text at the full width of asr_300m_202501
               (bf16 weights, int8 KV cache, bf16 Mimi with 32 codebooks, a
               `delay` condition), all from a seed, B = 256 slots of
               BatchedAsrState, each frame replays of StreamingASR's two
               graphs (Mimi encode, the temporal step) captured at its
               first frame after the warm-up: the greedy isolation run of
               the batched phase over 40 frames (text tokens and Word /
               EndWord messages; the text head's pad columns are scaled up
               so that words end) with a session resume in it (a session
               leaves at frame 15, a new tenant takes its slot, it resumes
               on another slot and must repeat an unbroken slot's tokens,
               messages and device rows), run graphed and eagerly, whose
               tokens, messages and every state byte must be equal; exactly
               16 decode_attention_int8 and no GEMV launches per captured
               step (and per eager frame), the replay counts; p50 / p75 /
               p90 ms per batched frame; 10 frames of every slot on both
               engines (frame times, the word trackers' host ms, peak
               memory, a profiler pass); then the greedy run eagerly with
               decode_attention_int8_plain in the kernel's place, in which
               slot 0 must say words too; then graphed engines at B = 256,
               512 and 1024, 20 frames of every slot each (p50 / p90, peak
               memory), naming the largest B whose p90 stays under 80 ms;
               the weights are written as a native speech-to-text
               checkpoint (the `delay` conditioner's tensors in the LM's
               file, stt_config, a synthetic tokenizer) into build/;
 7a. stt     - run_inference.main over that checkpoint (model_type stt,
               stt_config's silence before and after), B = 1, over 4 s of
               seeded PCM: one step a padded frame, 16
               decode_attention_int8 launches a step and no GEMV, text
               tokens in range, ms/step p50/p90;
 7b. worker  - serve/worker.py's build_app on one TOML of three modules:
               the Moshi server over [serve]'s checkpoint, batched Moshi
               over it at B = 16 with the int4 KV cache and a bf16 Mimi,
               batched ASR over [asr]'s at B = 64 with the int8 KV cache,
               each loaded, warmed up and its graphs captured, served by
               aiohttp on 127.0.0.1 with an API key: 401 without it,
               /api/modules_info, /metrics; 16 MessagePack ASR clients and
               one of the legacy framing (twin pairs on one PCM stream, 40
               frames each as fast as the socket takes them, markers
               before frames 10, 20 and 30; one client leaves after frame
               15 and resumes under its resume id), whose twins must say
               the same words and whose markers must come back after the
               words of the audio before them; the batched Moshi module
               driven through its own acquire_slot / feed_pcm /
               slot_queues under the worker's run_loop (7 twin pairs of 40
               greedy frames, and a twin that leaves after frame 15 and
               resumes on another slot), token for token; one raw-PCM
               session on /api/chat whose greedy tokens must equal
               [serve]'s session 1; the launches of the phase exactly each
               module's warm-up frames and one capture, none while
               serving; load and warm-up s of each module, p50/p90 ms per
               batched frame of both loops, peak memory;
 7c. fleet   - the serving fleet over both checkpoints, which are then
               deleted: (a) `python -m moshi_tpu_torch.serve.dispatcher`
               with its vault and three `python -m
               moshi_tpu_torch.serve.worker` processes a, b, c on the one
               card (a `moshi` module replicating every 25 frames, a
               session log directory, and a `py` module that answers its
               process's launch counts): unbroken greedy and sampled
               sessions of 100 frames on b; a client ticketed by the
               dispatcher to a streams 60 greedy frames with a resume id, a
               is killed (SIGKILL) once its pushes have landed, the client
               re-queues, is handed b and resumes there from the vault's
               step to frame 100; the same sampled from c to b; each held
               to the unbroken session byte for byte (PCM, text) and token
               for token (b's session logs), 129 q4_gemv + 208 int8_mma a
               captured step and none while those sessions ran, frame
               p50/p90/worst on a beside [serve]'s p50, the snapshot's
               bytes and each push's seconds; (b) MT 8 in-process on a
               ServerState over seeded lm_config_v0_1_vision weights (q4
               temporal and cross projections, int8 depformer), graphed
               and eager: 10 frames, an image of 16 seeded embedding
               frames, 20 frames, a second image, 10 frames; acks, every
               message and token equal, the second image's K/V written
               into the first one's tensors and equal to
               precompute_cross's eager rows, launches a step without and
               with the cross block; (c) build_app of a py_batched_asr
               module (a script written here, the bitmask protocol over
               StreamingASR, eager) beside batched_asr, both B = 16 over
               [asr]'s checkpoint: 4 socket clients each over the same
               seeded PCM, text tokens and words compared (a difference
               reported with its first frame), 16 decode_attention_int8
               a py frame and none from the captured engine;
  8. tts     - batched text-to-speech at the full width of tts_v0_1 (48
               layers of dim 2048, 32 heads x 64, a 16-step depformer;
               int8 weights, int4 KV at context 1000, bf16 Mimi with 16
               codebooks, a seeded speaker_wavs condition over voices of
               125 x 512 fused by cross-attention and a `cfg` LUT condition
               summed in, the JAX benchmark's tokenizer stub and state
               machine): TTSModel.get_prefix on 2 s of seeded PCM, whose
               audio rows must equal that Mimi's offline encode; then B =
               16 slots of BatchedTTSState, each frame
               replays of its two graphs (scatter -> temporal step -> text
               sampling; depformer -> commit -> Mimi decode) with the DSM
               machines on the host between them: a greedy isolation run
               of 44 frames (a voiceless slot alone first, two slots with
               one script and voice, one joining 5 ticks late, one starved
               of words for 5 ticks, one reset to them, one changing its
               voice) whose copies must repeat slot 0's frames and Text
               events, graphed and eager held equal in frames, events, PCM
               and every state byte, with exact launches per captured
               graph (int8_mma, int8_gemv, 48 fused decode_attention_int4,
               no q4) and the replay counts; a sampled run of every slot
               (40 graphed frames, 10 eager: p50/p75/p90, ms per stream,
               the machines' host ms, peak memory, a profiler pass); then
               the greedy run with the int8 KV cache (48
               decode_attention_int8 per frame) and 5 frames of every
               slot; the weights are then written as a native TTS
               checkpoint (the conditioners' tensors in the LM's file,
               tts_config, model_id, a synthetic tokenizer and a voice
               directory of 4 seeded speaker_wavs files) into build/,
               loaded back, every leaf held equal;
  9. tts_serve - the TTS and codec entry points over that checkpoint:
               run_tts's main in-process (two texts in two voices named in
               the voice directory, greedy: two wavs, seconds of audio per
               second, launches K3 and K4 + K5 only); then serve/worker.py's
               build_app on one TOML of three modules, batched_tts (B = 16,
               int4 KV, bf16 Mimi, the distilled model's `cfg` condition),
               tts (one captured streamer, int8 KV) and mimi (one room),
               whose build launches exactly each TTS engine's warm-up and
               captures and whose serving launches none: 15 greedy
               batched sessions through the module's slot API and queues
               under its run_loop (twins equal in tokens, words and PCM, a
               session that leaves with a resume id and resumes on another
               slot while a tenant dirties its old one equal to its twin, a
               voice change; p50/p90 ms per batched frame beside [tts]'s
               greedy p50, time to first audio), three tts sessions in turn
               (the third, with the first's voice and words, equal to it),
               and the Mimi socket over aiohttp on 127.0.0.1 (two clients
               of 40 frames in ragged chunks, codes equal to encode_step's
               and PCM to decode_step's from fresh states, frames per
               second; a room whose two listeners hear the same bytes, raw
               f32le, as the card's machine has no libopus); the
               checkpoint is deleted.
Then a [done] line with the seconds every phase took, a JSON line of the
kernels, the card's name and power limit, and as the last line {"ok":
true, "device": {...}}.  Any failed check raises, so the
script exits non-zero and prints no result.
"""

import asyncio
import gc
import io
import json
import re
import shutil
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager, nullcontext, redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if not (ROOT / "moshi_tpu_torch" / "csrc").is_dir():
    sys.exit(f"chip_smoke.py: no moshi_tpu_torch package beside {__file__}")
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 1234
SESSIONS = (11, 12, 11)  # session seeds; the first and last are equal
FRAMES = 40
EAGER_FRAMES = 10        # the eager comparison run of [batched]'s sampled run
SLOTS = 16               # B of the batched phase
ASR_SLOTS = 256          # B of the asr phase
ASR_SWEEP = (256, 512, 1024)  # B of the asr phase's batch sweep
ASR_DELAY = 6            # asr_delay_in_tokens: 0.5 s at 12.5 Hz
# the `delay` conditioner of the asr phase (no checkpoint on the card's
# machine: its width and value are this script's choice)
ASR_COND = {"dim": 1024, "scale_factor": 1.0, "max_period": 10_000.0, "delay": 0.5}
BATCHES = (1, 4, 9, 16)  # GEMV checks
MMA_BATCHES = (2, 4, 9, 16)  # q4_mma checks (bf16 x only)
INT8_MMA_BATCHES = (1, 2, 4, 9, 16)  # int8_mma checks (bf16 x only)
CROSSOVER_BATCHES = (1, 2, 4, 8, SLOTS)  # both kernels of each GEMV family timed
# asr: factors of the seeded text head's columns of the end-pad (0) and pad
# (3) ids.  The random model's hidden state varies little, so its greedy
# stream settles on a few tokens and never emits a pad; with these factors
# the pads win on some frames, words end, and slot 0's session holds Word
# and EndWord messages.  The stream turns on near-ties, so it moves with
# any rounding on the path (the attention's, the int8 KV quantization's):
# of 36 pairs tried, only these gave slot 0 words with the kernel of
# csrc/decode_attention_int8.cu and with its plain version alike once the
# quantization divided on the card as on the CPU (PERF.md), and run_asr
# checks the plain one's.
ASR_PAD_LOGIT_SCALE = {0: 25.0, 3: 50.0}
# max |kernel - plain| / max |plain|
BOUNDS = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# decode_attention_int4 takes q / sqrt(D) in bf16 (as the TPU kernel does):
# relative error of acc / l and of m
ATTN_BOUND = 2e-2
# main-path shapes (din, dout) of Moshi-7B -> launches per LMGen.step.
# q4: temporal in_proj, out_proj, linear_in, linear_out (32 layers) and the
# text head.  int8: depformer in_proj, out_proj, linear_in, linear_out (6
# layers x 8 codebooks), the output heads (linears) and depformer_in.
Q4_SHAPES = {(4096, 12288): 32, (4096, 4096): 32, (4096, 22528): 32,
             (11264, 4096): 32, (4096, 32000): 1}
INT8_SHAPES = {(1024, 3072): 48, (1024, 1024): 48, (1024, 5632): 48,
               (2816, 1024): 48, (1024, 2048): 8, (4096, 1024): 8}
# q4_wgmma above a decoding batch (the offline forward's M = B * T rows, 256
# in [offline] and 512 in [train]): checked and timed at these row counts
# at every Q4_SHAPES shape, whose counts are also the launches of one
# offline forward, and at
# CROSSOVER_ROWS beside q4_mma (the route keeps q4_mma there); the f32
# route (the q4_gemv kernel, one launch per 16 rows) checked at
# F32_ROUTE_ROWS
OFFLINE_ROWS = (32, 64, 256, 512)
CROSSOVER_ROWS = 16
F32_ROUTE_ROWS = 40
# int8 above a decoding batch: int8_gemv runs bf16 x of more than 16 rows as
# one int8_wgmma launch; checked at INT8_CHECK_ROWS (the edges of its 64-row
# warpgroups and 128-row tiles) and timed at INT8_ROWS at every INT8_SHAPES
# shape (the depformer's), beside the 16-row int8_mma chunks it replaces,
# torch.matmul on the bf16 weight and the bound; then int8_linear under
# autograd at 512 rows
INT8_ROWS = (17, 32, 64, 512)
INT8_CHECK_ROWS = (17, 33, 63, 64, 65, 127, 128, 129, 200, 512)
# the offline phase: Mimi v0.1 over B = 4 x 50 frames (4 s) of seeded PCM
# plus one input 1000 samples longer (encode pads it to a whole frame), and
# Moshi-7B's teacher-forced forward over seeded codes [2, 17, 128] (256 rows
# for each q4 linear)
OFFLINE_MIMI = {"batch": 4, "frames": 50, "extra": 1000}
OFFLINE_LM = {"batch": 2, "frames": 128}
# offline against streaming (PERF.md §6, stated before the first run): the
# share of equal codes (at least) and max |offline - streaming| / max
# |streaming| of the decoded PCM (at most), by Mimi's dtype; and
# ||offline - streaming|| / ||streaming|| of the LM's bf16 text logits (the
# norm over all 8.2M logits; the max-based error is printed beside it)
OFFLINE_BOUNDS = {"f32": {"share": 0.999, "pcm": 1e-4},
                  "bf16": {"share": 0.5, "pcm": 1e-1}, "lm_text_logits": 2e-2}
TTS_PREFIX_SECONDS = 2   # the PCM of [tts]'s get_prefix call
# the configs phase: (a) a prefill of CONFIGS_CHUNK positions between
# CONFIGS_STEPS single steps at B = CONFIGS_BATCH over each KV cache,
# against as many single steps; (b) batched TTS at CONFIGS_TTS_ROWS model
# rows, CONFIGS_TTS_SLOTS slots without CFG and CONFIGS_TTS_CFG_SLOTS under
# true CFG at CONFIGS_TTS_CFG, CONFIGS_TTS_FRAMES frames graphed and
# CONFIGS_TTS_EAGER eager; (c) Mimi with every option and a transformer of
# d_model CONFIGS_MIMI_DIM between its 512-wide ends
CONFIGS_BATCH = 2
CONFIGS_STEPS = 8
CONFIGS_CHUNK = 64
CONFIGS_TTS_ROWS = 32
CONFIGS_TTS_SLOTS = 32
CONFIGS_TTS_CFG_SLOTS = 16
CONFIGS_TTS_CFG = 3.0
CONFIGS_TTS_FRAMES = 10
CONFIGS_TTS_EAGER = 5
CONFIGS_MIMI_DIM = 1024
# the int4 KV cache of the batched phase: Moshi-7B, context 3000
KV = {"layers": 32, "heads": 32, "head_dim": 128, "cap": 3000}
# the tts phase: tts_v0_1 with int8 weights, int4 KV at context 1000, B = 16
TTS_SLOTS = 16
TTS_FRAMES = 44          # the greedy isolation run
TTS_CONTEXT = 1000
TTS_DELAY_STEPS = 25     # the JAX benchmark's machine (moshi_tpu/benchmark.py:352-359)
TTS_TEMP = 0.6
# speaker embeddings: frames x width (no voice file on the card's machine:
# the script's choice), at most TTS_MAX_SPEAKERS of them in a condition
TTS_VOICE = (125, 512)
TTS_MAX_SPEAKERS = 5
# the `cfg` LUT condition of a CFG-distilled checkpoint (the script's choice)
TTS_CFG = {"n_bins": 7, "dim": 16,
           "possible_values": ["1.0", "1.5", "2.0", "2.5", "3.0", "3.5", "4.0"]}
# the TTS frame's int8 linears (din, dout) at B = 16 -> launches per frame:
# 48 temporal layers x (in_proj, out_proj, linear1, linear2, cross q_proj,
# cross out_proj) and the 32001-column text head; 16 depformer steps x 6
# layers x 4 linears, depformer_in and the 2049-entry audio heads per step
TTS_INT8_SHAPES = {(2048, 6144): 48, (2048, 2048): 3 * 48, (2048, 8192): 48,
                   (8192, 2048): 48, (2048, 32001): 1,
                   (1024, 3072): 96, (1024, 1024): 96, (1024, 5632): 96, (2816, 1024): 96,
                   (2048, 1024): 16, (1024, 2049): 16}
# Hibiki-2B (s2s_2b_16rvq_202501 with a Hibiki checkpoint's depformer
# fields) shapes (din, dout) -> launches per LMGen.step.  q4: temporal
# in_proj, out_proj, linear_in, linear_out (24 layers) and the 48000-column
# text head.  int8: the depformer's 4 linears (6 layers x 16 steps), its
# output heads and depformer_in (9 members for 16 steps) per step
HIBIKI_Q4_SHAPES = {(2560, 7680): 24, (2560, 2560): 24, (2560, 14080): 24,
                    (7040, 2560): 24, (2560, 48000): 1}
HIBIKI_INT8_SHAPES = {(1024, 3072): 96, (1024, 1024): 96, (1024, 5632): 96,
                      (2816, 1024): 96, (1024, 2048): 16, (2560, 1024): 16}
# the shapes [kernels] times for Hibiki (the other int8 ones are Moshi's),
# at the model rows of its runs: B = 1, and B = 2 under CFG
HIBIKI_TIMED = (*HIBIKI_Q4_SHAPES, (2560, 1024))
HIBIKI_ROWS = (1, 4)
# K4 (fused with the write) and K6 at the TTS shapes: L, B, H, D, cap
TTS_KV = {"layers": 48, "batch": TTS_SLOTS, "heads": 32, "head_dim": 64, "cap": TTS_CONTEXT}
# decode_attention_int8's main-path shapes, (B, heads, cap) at head dim 128:
# asr_300m_202501 at B = 256 (16 launches per frame), Moshi-7B at B = 16 (32)
INT8_KV = {"asr": (ASR_SLOTS, 8, 750), "moshi_b16": (SLOTS, 32, 3000),
           "tts": (TTS_SLOTS, TTS_KV["heads"], TTS_CONTEXT)}
TPU_KERNELS = {
    # q4gemm and q4gemm_stacked: q4_gemv on the CUDA cores (B = 1, f32),
    # q4_mma on the tensor cores (bf16, M = MMA_MIN_BATCH..16 rows),
    # q4_wgmma with wgmma (bf16, M > 16 rows)
    "q4_gemv": "moshi_tpu/ops/q4matmul.py:83, moshi_tpu/ops/q4matmul.py:144",
    "q4_mma": "moshi_tpu/ops/q4matmul.py:83, moshi_tpu/ops/q4matmul.py:144",
    "q4_wgmma": "moshi_tpu/ops/q4matmul.py:83, moshi_tpu/ops/q4matmul.py:144",
    # qgemv: int8_gemv on the CUDA cores (f32, widths off 64), int8_mma on
    # the tensor cores (bf16, B = 1..16), int8_wgmma with wgmma (bf16, M > 16)
    "int8_gemv": "moshi_tpu/ops/qmatmul.py:48",
    "int8_mma": "moshi_tpu/ops/qmatmul.py:48",
    "int8_wgmma": "moshi_tpu/ops/qmatmul.py:48",
    "decode_attention_int4": "moshi_tpu/ops/int4_attention.py:165",
    "cache_write_int4": "moshi_tpu/ops/int4_attention.py:313",
    "decode_attention_int8": "moshi_tpu/ops/decode_attention.py:90",
}
SOURCES = {name: f"moshi_tpu_torch/csrc/{name}.cu" for name in TPU_KERNELS}
# the cache write runs in decode_attention_int4's launch
SOURCES["cache_write_int4"] = SOURCES["decode_attention_int4"]
# the designs before the write moved into the attention's launch, on the
# H100 (PERF.md §6): the standalone cache_write_int4 kernel per int4 B = 16
# frame, and the attention alone per launch at that frame's shape
EARLIER_MS = {"cache_write_int4 per frame": 0.174, "decode_attention_int4 per launch": 0.0880}
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def free_memory() -> None:
    """Return what dropped engines held to the card before the next phase
    measures memory: the cycle collector for anything still in a
    reference cycle, then the allocator's cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    return ((y.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least ms the card could take: bytes over HBM bandwidth or bf16 flops
    over the tensor-core peak, the larger, and which of the two it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, operands, iters: int = 20, reps: int = 3) -> float:
    """Device ms per call.  `iters` calls, cycling through `operands`
    (copies larger in total than the 50 MB L2, so each call reads its
    operands from device memory as the main path does), are captured in a
    CUDA graph after one warm-up call per operand set on the capture's side
    stream (moshi_tpu_torch.utils.graphs); the graph's replays are timed
    with CUDA events, so the host's launch cost is not in the number."""
    from moshi_tpu_torch.utils.graphs import capture, side_stream

    side = torch.cuda.Stream()
    with side_stream(side):
        for ops in operands:
            fn(*ops)
    graph, _ = capture(lambda: [fn(*operands[i % len(operands)]) for i in range(iters)],
                       stream=side)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


def copies_for_cold_l2(nbytes: int) -> int:
    return max(2, -(-256 * 2 ** 20 // nbytes))


def ptxas_summary(log: str) -> tuple[int, int]:
    """Most registers of any kernel instance and total spill bytes, from
    nvcc -Xptxas -v output."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    return max(regs, default=0), spills


# ---------------------------------------------------------------- kernels
def _check_against_plain(name, fn, plain, qt, x) -> float:
    """Raise unless fn(x, q, scale) is within BOUNDS of the plain version;
    returns max |fn - plain|."""
    y = fn(x, qt.q, qt.scale)
    torch.cuda.synchronize()
    ref = plain(x, qt.q, qt.scale)
    err = rel_err(y, ref)
    din, dout = x.shape[1], qt.q.shape[-1]
    ok = err <= BOUNDS[x.dtype] and bool(torch.isfinite(y).all())
    phase("kernels", f"{name} {din}x{dout} B={x.shape[0]} {str(x.dtype)[6:]}: max rel err "
          f"{err:.3e} (bound {BOUNDS[x.dtype]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version")
    return (y.float() - ref.float()).abs().max().item()


def plan_phrase(name, B, din, q) -> str:
    """The launch plan of the q4_gemv / int8_gemv kernel for x of B rows on
    q (gemv_plan: a lane's columns, warps a block, blocks a cluster), as a
    phrase; "" for another kernel."""
    from moshi_tpu_torch.ops import q4matmul, qmatmul

    if name == "q4_gemv":
        p = q4matmul.q4_gemv_plan(min(B, q4matmul.MAX_BATCH), din, q, 32, True, q.device)
    elif name == "int8_gemv":
        p = qmatmul.int8_gemv_plan(B, din, q, True, q.device)
    else:
        return ""
    return (f" [plan: {p.cols} columns a lane, {p.warps} warps, cluster {p.cluster}, "
            f"{p.rows_per_block} rows a block]")


def check_gemvs(dev, g, families=("q4", "int8")) -> list[dict]:
    """The weight-only GEMV kernels against their plain versions at every
    main-path shape: the q4_gemv and int8_gemv kernels at BATCHES in bf16
    and f32, q4_mma at MMA_BATCHES and int8_mma at INT8_MMA_BATCHES in
    bf16.  Then, at the main paths' operands (bf16, weights cold in L2),
    each kernel's time beside its plain version's, torch.matmul's on the
    bf16 weights and the bound, summed over one frame's launches (Q4_SHAPES
    / INT8_SHAPES counts) at CROSSOVER_BATCHES, and each family's
    crossover.  Returns a row per kernel."""
    from moshi_tpu_torch.ops import q4matmul, qmatmul
    from moshi_tpu_torch.utils.quantize import (dequantize, dequantize4, quantize_tensor,
                                                quantize_tensor4)

    both = (torch.bfloat16, torch.float32)
    # family -> ({kernel: (wrapper, checked dtypes, checked batches)}, plain
    # version, quantizer, dequantizer, shapes, timed batches)
    table = {"q4": ({"q4_gemv": (q4matmul.q4_gemv_kernel, both, BATCHES),
                     "q4_mma": (q4matmul.q4_mma, (torch.bfloat16,), MMA_BATCHES)},
                    q4matmul.q4_gemv_plain, quantize_tensor4, dequantize4, Q4_SHAPES,
                    q4matmul.MMA_MIN_BATCH),
             "int8": ({"int8_gemv": (qmatmul.int8_gemv_kernel, both, BATCHES),
                       "int8_mma": (qmatmul.int8_mma, (torch.bfloat16,), INT8_MMA_BATCHES)},
                      qmatmul.int8_gemv_plain, quantize_tensor, dequantize, INT8_SHAPES,
                      qmatmul.MMA_MIN_BATCH)}
    rows = []
    for family in families:
        kernels, plain, quant, deq, shapes, min_batch = table[family]
        simt, mma = kernels
        timed = CROSSOVER_BATCHES
        max_abs = dict.fromkeys(kernels, 0.0)
        per_frame = {k: {B: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
                         for B in timed} for k in kernels}
        by_shape, bound_by = {k: {} for k in kernels}, set()
        for (din, dout), n in shapes.items():
            w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
            qt = quant(w)
            for name, (fn, dtypes, batches) in kernels.items():
                for B in batches:
                    for dt in dtypes:
                        x = torch.randn(B, din, device=dev, generator=g).to(dt)
                        max_abs[name] = max(max_abs[name],
                                            _check_against_plain(name, fn, plain, qt, x))
            bytes_w = qt.q.numel() + 4 * qt.scale.numel()
            copies = [quant(w) for _ in range(copies_for_cold_l2(bytes_w))]
            dense = [deq(qt.q, qt.scale, torch.bfloat16)
                     for _ in range(copies_for_cold_l2(2 * din * dout))]
            for B in timed:
                x = torch.randn(B, din, device=dev, generator=g).to(torch.bfloat16)
                ops = [(x, c.q, c.scale) for c in copies]
                shared = {"plain_ms": time_ms(plain, ops),
                          "library_ms": time_ms(torch.matmul, [(x, d) for d in dense])}
                shared["bound_ms"], by = bound(bytes_w + 2 * B * (din + dout), 2 * B * din * dout)
                bound_by.add(by)
                for name, (fn, _, _) in kernels.items():
                    t = {"ms": time_ms(fn, ops), **shared}
                    for k, v in t.items():
                        per_frame[name][B][k] += n * v
                    by_shape[name][f"{din}x{dout} B={B}"] = t
                    phase("kernels", f"{name} {din}x{dout} B={B} bf16: kernel {t['ms']:.4f} ms, "
                          f"plain {t['plain_ms']:.4f} ms, torch.matmul on bf16 "
                          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; "
                          f"{bytes_w / t['ms'] / 1e6:.1f} GB/s of packed weight"
                          + plan_phrase(name, B, din, qt.q))
            if family == "int8":
                by_shape["int8_gemv"][f"{din}x{dout} int8pack"] = int8pack_ms(qt, din, dev, g)
            del copies, dense
        torch.cuda.synchronize()
        rows += [{"name": name, "max_abs_err": max_abs[name], "per_frame": per_frame[name],
                  "by_shape": by_shape[name],
                  "bound_by": "operations" if bound_by == {"operations"} else "bytes"}
                 for name in kernels]
        if family == "int8":
            rows[-1]["launch_floor_ms"] = launch_floor_ms(dev, g)
        faster = []
        for B in timed:
            t = {k: per_frame[k][B] for k in kernels}
            if t[mma]["ms"] < t[simt]["ms"]:
                faster.append(B)
            phase("kernels", f"{family} per frame ({sum(shapes.values())} launches) B={B}: "
                  f"{simt} kernel {t[simt]['ms']:.3f} ms, {mma} {t[mma]['ms']:.3f} ms, "
                  f"torch.matmul on bf16 {t[mma]['library_ms']:.3f} ms, bound "
                  f"{t[mma]['bound_ms']:.3f} ms")
        phase("kernels", f"{family} crossover: {mma} faster at B = {faster}; the route sends "
              f"bf16 B >= MMA_MIN_BATCH = {min_batch} to {mma}")
    return rows


def check_tts_gemvs(dev, g) -> dict:
    """The int8 GEMVs at the TTS frame's shapes (TTS_INT8_SHAPES), B =
    TTS_SLOTS: each shape on the kernel its route takes (int8_mma where
    qmatmul.use_mma says so, else the int8_gemv kernel, which the heads of
    32001 and 2049 columns take) against the plain version in bf16 (the
    int8_gemv kernel in f32 too); then in bf16, weights cold in L2, its time
    beside the plain version's, torch.matmul's on the bf16 weights and the
    bound, summed by kernel over one frame's launches.  Returns {kernel:
    its summary}."""
    from moshi_tpu_torch.ops import qmatmul
    from moshi_tpu_torch.utils.quantize import dequantize, quantize_tensor

    B, plain = TTS_SLOTS, qmatmul.int8_gemv_plain
    out = {name: {"per_frame": dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0),
                  "launches_per_frame": 0, "by_shape": {}, "max_abs_err": 0.0, "bound_by": set()}
           for name in ("int8_mma", "int8_gemv")}
    for (din, dout), n in TTS_INT8_SHAPES.items():
        qt = quantize_tensor(torch.randn(din, dout, device=dev, generator=g) / din ** 0.5)
        mma = qmatmul.use_mma(B, torch.bfloat16, din, dout)
        name, fn = ("int8_mma", qmatmul.int8_mma) if mma else ("int8_gemv",
                                                                qmatmul.int8_gemv_kernel)
        row = out[name]
        for dt in (torch.bfloat16,) if mma else (torch.bfloat16, torch.float32):
            x = torch.randn(B, din, device=dev, generator=g).to(dt)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     _check_against_plain(name, fn, plain, qt, x))
        bytes_w = qt.q.numel() + 4 * qt.scale.numel()
        copies = [qt] + [quantize_tensor(dequantize(qt.q, qt.scale, torch.float32))
                         for _ in range(copies_for_cold_l2(bytes_w) - 1)]
        dense = [dequantize(qt.q, qt.scale, torch.bfloat16)
                 for _ in range(copies_for_cold_l2(2 * din * dout))]
        x = torch.randn(B, din, device=dev, generator=g).to(torch.bfloat16)
        ops = [(x, c.q, c.scale) for c in copies]
        t = {"ms": time_ms(fn, ops), "plain_ms": time_ms(plain, ops),
             "library_ms": time_ms(torch.matmul, [(x, d) for d in dense])}
        t["bound_ms"], by = bound(bytes_w + 2 * B * (din + dout), 2 * B * din * dout)
        row["bound_by"].add(by)
        for k, v in t.items():
            row["per_frame"][k] += n * v
        row["launches_per_frame"] += n
        row["by_shape"][f"{din}x{dout} B={B}"] = {**t, "launches_per_frame": n}
        phase("kernels", f"tts {name} {din}x{dout} B={B} bf16 ({n} per frame): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.matmul on bf16 "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; "
              f"{bytes_w / t['ms'] / 1e6:.1f} GB/s of packed weight"
              + plan_phrase(name, B, din, qt.q))
        del copies, dense
    for name, row in out.items():
        row["bound_by"] = "operations" if row["bound_by"] == {"operations"} else "bytes"
        f = row["per_frame"]
        phase("kernels", f"tts per frame: {name} x {row['launches_per_frame']} at B={B}: "
              f"kernel {f['ms']:.3f} ms, plain {f['plain_ms']:.3f} ms, torch.matmul on bf16 "
              f"{f['library_ms']:.3f} ms, bound {f['bound_ms']:.3f} ms")
    free_memory()
    return out


def chunked_int8_mma(x, q, scale):
    """The route int8_wgmma replaced above 16 rows: 16-row chunks of x, one
    int8_mma launch each, their outputs concatenated (timed beside it)."""
    from moshi_tpu_torch.ops import qmatmul

    chunks = [c if c.data_ptr() % 16 == 0 else c.clone() for c in x.split(16)]
    return torch.cat([qmatmul.int8_mma(c, q, scale) for c in chunks])


def int8_rows_times(dev, g, din: int, dout: int, checked: tuple, timed: tuple):
    """int8_gemv above 16 rows at one weight shape, on the kernel its route
    takes (int8_route: one int8_wgmma launch, or 16-row chunks of the
    int8_gemv kernel for widths off 64): checked against the plain version
    at every row count of `checked` and `timed`, with exactly the route's
    launches, then timed at `timed` (operands cold in L2) beside the plain
    version, torch.matmul on the bf16 weight and the bound, and, where the
    route is int8_wgmma, beside the 16-row int8_mma chunks it replaced
    (chunked_ms).  Returns (the kernel's name, {M: times}, max |kernel -
    plain| / max |plain|)."""
    from moshi_tpu_torch.ops import qmatmul
    from moshi_tpu_torch.utils.quantize import dequantize, quantize_tensor

    plain = qmatmul.int8_gemv_plain
    w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
    qt = quantize_tensor(w)
    bytes_w = qt.q.numel() + 4 * qt.scale.numel()
    copies = [qt] + [quantize_tensor(w) for _ in range(copies_for_cold_l2(bytes_w) - 1)]
    del w
    dense = [dequantize(qt.q, qt.scale, torch.bfloat16)
             for _ in range(copies_for_cold_l2(2 * din * dout))]
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counted = ("int8_gemv", "int8_mma", "int8_wgmma")
    times, max_abs, name = {}, 0.0, None
    for M in sorted(set(checked + timed)):
        name, n = int8_route(M, din, dout)
        x = torch.randn(M, din, device=dev, generator=g).to(torch.bfloat16)
        before = read_counts()
        max_abs = max(max_abs, _check_against_plain(f"int8 rows ({name})", qmatmul.int8_gemv,
                                                    plain, qt, x))
        after = read_counts()
        launched = {k: after[k] - before[k] for k in counted}
        if launched != {**dict.fromkeys(counted, 0), name: n}:
            raise RuntimeError(f"int8 {din}x{dout} at M = {M} launched {launched}, not {n} "
                               f"{name}")
        if M not in timed:
            continue
        ops = [(x, c.q, c.scale) for c in copies]
        t = {"ms": time_ms(qmatmul.int8_gemv, ops, iters=10 if n > 1 else 20),
             "plain_ms": time_ms(plain, ops),
             "library_ms": time_ms(torch.matmul, [(x, d) for d in dense]), "launches": n}
        if name == "int8_wgmma":
            t["chunked_ms"] = time_ms(chunked_int8_mma, ops, iters=10)
            split_rows, splits = qmatmul.int8_wgmma_plan(din, dout, num_sms, M)
            t["plan"] = {"split_rows": split_rows, "splits": splits}
        t["bound_ms"], t["bound_by"] = bound(bytes_w + 2 * M * (din + dout), 2 * M * din * dout)
        times[M] = t
    del copies, dense
    return name, times, max_abs


def rows_phrase(t: dict) -> str:
    """An int8 rows timing as a phrase: the kernel, beside the chunks it
    replaced where it is int8_wgmma, the plain version, torch.matmul and
    the bound."""
    chunked = (f" (the 16-row int8_mma chunks {t['chunked_ms']:.4f} ms)"
               if "chunked_ms" in t else "")
    return (f"{t['ms']:.4f} ms{chunked}, plain {t['plain_ms']:.4f} ms, torch.matmul on bf16 "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")


def check_tts_rows(dev, g) -> dict:
    """The TTS frame's int8 linears (TTS_INT8_SHAPES) at CONFIGS_TTS_ROWS
    rows, on the route [configs] (b) takes (int8_rows_times: int8_wgmma,
    the heads' int8_gemv chunks), summed by kernel over one frame's
    linears.  Returns {kernel: its summary}."""
    M, keys = CONFIGS_TTS_ROWS, ("ms", "plain_ms", "library_ms", "bound_ms")
    out = {name: {"per_frame": dict.fromkeys(keys, 0.0), "launches_per_frame": 0,
                  "by_shape": {}, "max_abs_err": 0.0, "bound_by": set()}
           for name in ("int8_wgmma", "int8_gemv")}
    out["int8_wgmma"]["per_frame"]["chunked_ms"] = 0.0
    for (din, dout), n in TTS_INT8_SHAPES.items():
        name, times, err = int8_rows_times(dev, g, din, dout, (), (M,))
        t, row = times[M], out[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["bound_by"].add(t["bound_by"])
        for k in row["per_frame"]:
            row["per_frame"][k] += n * t[k]
        row["launches_per_frame"] += n * t["launches"]
        row["by_shape"][f"{din}x{dout} M={M}"] = {**t, "launches_per_frame": n * t["launches"]}
        phase("kernels", f"tts {name} {din}x{dout} M={M} bf16 ({n} per frame, {t['launches']} "
              f"launches each): {rows_phrase(t)}")
    for name, row in out.items():
        row["bound_by"] = "operations" if row["bound_by"] == {"operations"} else "bytes"
        phase("kernels", f"tts per frame at {M} rows: {name} x {row['launches_per_frame']}: "
              f"{rows_phrase({**row['per_frame'], 'bound_by': row['bound_by']})}")
    free_memory()
    return out


def check_hibiki_gemvs(dev, g) -> dict:
    """The GEMVs at Hibiki-2B's new shapes (HIBIKI_TIMED: the five q4 ones
    and depformer_in 2560 -> 1024) at HIBIKI_ROWS rows, each on the kernel
    its route takes, against the plain version in bf16; then, weights cold
    in L2, its time beside the plain version's, torch.matmul's on the bf16
    weight and the bound, summed by kernel over one LMGen.step's launches
    of these shapes (HIBIKI_Q4_SHAPES / HIBIKI_INT8_SHAPES counts).
    Returns {kernel: its summary}."""
    from moshi_tpu_torch.ops import q4matmul, qmatmul
    from moshi_tpu_torch.utils.quantize import (dequantize, dequantize4, quantize_tensor,
                                                quantize_tensor4)

    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    out = {}
    for din, dout in HIBIKI_TIMED:
        q4 = (din, dout) in HIBIKI_Q4_SHAPES
        n = (HIBIKI_Q4_SHAPES if q4 else HIBIKI_INT8_SHAPES)[(din, dout)]
        quant, deq = (quantize_tensor4, dequantize4) if q4 else (quantize_tensor, dequantize)
        plain = q4matmul.q4_gemv_plain if q4 else qmatmul.int8_gemv_plain
        w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
        qt = quant(w)
        bytes_w = qt.q.numel() + 4 * qt.scale.numel()
        copies = [quant(w) for _ in range(copies_for_cold_l2(bytes_w))]
        dense = [deq(qt.q, qt.scale, torch.bfloat16)
                 for _ in range(copies_for_cold_l2(2 * din * dout))]
        for B in HIBIKI_ROWS:
            if q4:
                name = q4matmul.route(B, torch.bfloat16, 32, dout)
                fn = {"q4_gemv": q4matmul.q4_gemv_kernel, "q4_mma": q4matmul.q4_mma}[name]
            else:
                name, fn = "int8_mma", qmatmul.int8_mma
                if not qmatmul.use_mma(B, torch.bfloat16, din, dout):
                    raise RuntimeError(f"hibiki: int8 {din}x{dout} B={B} leaves int8_mma")
            row = out.setdefault(name, {"per_step": {}, "by_shape": {}, "max_abs_err": 0.0,
                                        "launches_per_step": {}, "bound_by": set()})
            x = torch.randn(B, din, device=dev, generator=g).to(torch.bfloat16)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     _check_against_plain(name, fn, plain, qt, x))
            ops = [(x, c.q, c.scale) for c in copies]
            t = {"ms": time_ms(fn, ops), "plain_ms": time_ms(plain, ops),
                 "library_ms": time_ms(torch.matmul, [(x, d) for d in dense])}
            t["bound_ms"], by = bound(bytes_w + 2 * B * (din + dout), 2 * B * din * dout)
            row["bound_by"].add(by)
            step = row["per_step"].setdefault(B, dict.fromkeys(keys, 0.0))
            for k, v in t.items():
                step[k] += n * v
            row["launches_per_step"][B] = row["launches_per_step"].get(B, 0) + n
            row["by_shape"][f"{din}x{dout} B={B}"] = {**t, "launches_per_step": n}
            phase("kernels", f"hibiki {name} {din}x{dout} B={B} bf16 ({n} per step): kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.matmul on bf16 "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; "
                  f"{bytes_w / t['ms'] / 1e6:.1f} GB/s of packed weight"
                  + plan_phrase(name, B, din, qt.q))
        del copies, dense
    for name, row in out.items():
        row["bound_by"] = "operations" if row["bound_by"] == {"operations"} else "bytes"
        for B, f in row["per_step"].items():
            phase("kernels", f"hibiki per step: {name} x {row['launches_per_step'][B]} at "
                  f"B={B}: kernel {f['ms']:.3f} ms, plain {f['plain_ms']:.3f} ms, "
                  f"torch.matmul on bf16 {f['library_ms']:.3f} ms, bound "
                  f"{f['bound_ms']:.3f} ms")
    free_memory()
    return out


def check_offline_q4(dev, g) -> dict:
    """q4_wgmma above a decoding batch, at OFFLINE_ROWS rows and every
    Q4_SHAPES shape: against the plain version in bf16, then (operands cold
    in L2) its time beside the plain version's, torch.matmul's on the
    dequantized bf16 weight and the bound, with TFLOP/s, and the sums over
    one offline forward's launches at each row count.  At CROSSOVER_ROWS
    (where the route keeps q4_mma) q4_wgmma and q4_mma are checked and timed
    side by side, for the record.  Then the f32 route (q4_gemv -> the
    q4_gemv kernel, ceil(M / 16) launches) at F32_ROUTE_ROWS rows against
    its plain version."""
    from moshi_tpu_torch.ops import q4matmul
    from moshi_tpu_torch.utils.quantize import dequantize4, quantize_tensor4

    plain = q4matmul.q4_gemv_plain
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    rows = OFFLINE_ROWS + (CROSSOVER_ROWS,)
    per_forward = {M: dict.fromkeys(keys, 0.0) for M in rows}
    crossover_mma_ms = 0.0
    by_shape, max_abs, bound_by = {}, 0.0, {M: set() for M in rows}
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (din, dout), n in Q4_SHAPES.items():
        w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
        qt = quantize_tensor4(w)
        bytes_w = qt.q.numel() + 4 * qt.scale.numel()
        copies = [qt] + [quantize_tensor4(w) for _ in range(copies_for_cold_l2(bytes_w) - 1)]
        del w
        dense = [dequantize4(qt.q, qt.scale, torch.bfloat16)
                 for _ in range(copies_for_cold_l2(2 * din * dout))]
        for M in rows:
            expect = "q4_mma" if M == CROSSOVER_ROWS else "q4_wgmma"
            if q4matmul.route(M, torch.bfloat16, 32, dout) != expect:
                raise RuntimeError(f"q4 {din}x{dout} at M = {M} would not run {expect}")
            x = torch.randn(M, din, device=dev, generator=g).to(torch.bfloat16)
            max_abs = max(max_abs, _check_against_plain("q4_wgmma", q4matmul.q4_wgmma, plain,
                                                        qt, x))
            ops = [(x, c.q, c.scale) for c in copies]
            t = {"ms": time_ms(q4matmul.q4_wgmma, ops), "plain_ms": time_ms(plain, ops),
                 "library_ms": time_ms(torch.matmul, [(x, d) for d in dense])}
            t["bound_ms"], by = bound(bytes_w + 2 * M * (din + dout), 2 * M * din * dout)
            t["bound_by"] = by
            t["tflops"] = 2 * M * din * dout / t["ms"] / 1e9
            bound_by[M].add(by)
            gps, splits = q4matmul.wgmma_plan_splits(din, dout, 32, num_sms, M)
            t["plan"] = {"groups_per_split": gps, "splits": splits}
            extra = ""
            if M == CROSSOVER_ROWS:
                _check_against_plain("q4_mma", q4matmul.q4_mma, plain, qt, x)
                t["q4_mma_ms"] = time_ms(q4matmul.q4_mma, ops)
                crossover_mma_ms += n * t["q4_mma_ms"]
                extra = f", q4_mma {t['q4_mma_ms']:.4f} ms (the route's)"
            by_shape[f"{din}x{dout} M={M}"] = t
            for k in keys:
                per_forward[M][k] += n * t[k]
            phase("kernels", f"q4_wgmma {din}x{dout} M={M} bf16 ({splits} splits): kernel "
                  f"{t['ms']:.4f} ms{extra}, plain {t['plain_ms']:.4f} ms, torch.matmul on bf16 "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by}); "
                  f"{t['tflops']:.1f} TFLOP/s")
        del copies, dense
    for M in rows:
        f = per_forward[M]
        f["bound_by"] = "operations" if bound_by[M] == {"operations"} else "bytes"
        f["tflops"] = 2 * M * sum(n * din * dout for (din, dout), n in Q4_SHAPES.items()) \
            / f["ms"] / 1e9
        what = "q4 offline forward" if M != CROSSOVER_ROWS else "q4 crossover, not a route:"
        extra = f", q4_mma {crossover_mma_ms:.3f} ms" if M == CROSSOVER_ROWS else ""
        phase("kernels", f"{what} ({sum(Q4_SHAPES.values())} launches) M={M}: "
              f"q4_wgmma {f['ms']:.3f} ms ({f['tflops']:.1f} TFLOP/s){extra}, plain "
              f"{f['plain_ms']:.3f} ms, torch.matmul on bf16 {f['library_ms']:.3f} ms, bound "
              f"{f['bound_ms']:.3f} ms ({f['bound_by']})")
    per_forward[CROSSOVER_ROWS]["q4_mma_ms"] = crossover_mma_ms

    M, (din, dout) = F32_ROUTE_ROWS, (4096, 4096)
    qt = quantize_tensor4(torch.randn(din, dout, device=dev, generator=g) / din ** 0.5)
    x = torch.randn(M, din, device=dev, generator=g)
    counted = (q4matmul.q4_gemv, q4matmul.q4_mma, q4matmul.q4_wgmma)
    before = [fn.launches for fn in counted]
    err = _check_against_plain("q4_gemv", q4matmul.q4_gemv, plain, qt, x)
    launched = tuple(fn.launches - b for fn, b in zip(counted, before))
    if launched != (-(-M // q4matmul.MAX_BATCH), 0, 0):
        raise RuntimeError(f"the f32 route at M = {M} launched (q4_gemv, q4_mma, q4_wgmma) "
                           f"{launched}")
    phase("kernels", f"q4 f32 route at M={M}: {launched[0]} q4_gemv kernel launches, "
          f"max |kernel - plain| {err:.3e}")
    free_memory()
    return {"per_forward": {M: per_forward[M] for M in OFFLINE_ROWS},
            "crossover": per_forward[CROSSOVER_ROWS], "by_shape": by_shape,
            "max_abs_err": max_abs, "launches_per_forward": sum(Q4_SHAPES.values()),
            "f32_route": {"rows": M, "shape": f"{din}x{dout}", "q4_gemv_launches": launched[0],
                          "max_abs_err": err}}


def check_helium_q4(dev, g) -> dict:
    """q4_wgmma at Helium-1 2B's prefill: HELIUM_PROMPT rows (a multiple of
    neither 16 nor 128: the last row tile mostly padding) at its five q4
    shapes, against the plain version in bf16; then (operands cold in L2)
    its time beside the plain version's, torch.matmul's on the bf16 weight
    and the bound, summed over the prefill's 97 launches."""
    from moshi_tpu_torch.ops import q4matmul
    from moshi_tpu_torch.utils.quantize import dequantize4, quantize_tensor4

    M, plain = HELIUM_PROMPT, q4matmul.q4_gemv_plain
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    total, by_shape, max_abs, bound_by = dict.fromkeys(keys, 0.0), {}, 0.0, set()
    for (din, dout), n in HELIUM_Q4_SHAPES.items():
        if q4matmul.route(M, torch.bfloat16, 32, dout) != "q4_wgmma":
            raise RuntimeError(f"helium q4 {din}x{dout} at M = {M} would not run q4_wgmma")
        w = torch.randn(din, dout, device=dev, generator=g) / din ** 0.5
        qt = quantize_tensor4(w)
        bytes_w = qt.q.numel() + 4 * qt.scale.numel()
        copies = [qt] + [quantize_tensor4(w) for _ in range(copies_for_cold_l2(bytes_w) - 1)]
        del w
        dense = [dequantize4(qt.q, qt.scale, torch.bfloat16)
                 for _ in range(copies_for_cold_l2(2 * din * dout))]
        x = torch.randn(M, din, device=dev, generator=g).to(torch.bfloat16)
        max_abs = max(max_abs, _check_against_plain("q4_wgmma", q4matmul.q4_wgmma, plain, qt,
                                                    x))
        ops = [(x, c.q, c.scale) for c in copies]
        t = {"ms": time_ms(q4matmul.q4_wgmma, ops), "plain_ms": time_ms(plain, ops),
             "library_ms": time_ms(torch.matmul, [(x, d) for d in dense])}
        t["bound_ms"], by = bound(bytes_w + 2 * M * (din + dout), 2 * M * din * dout)
        bound_by.add(by)
        by_shape[f"{din}x{dout} M={M}"] = {**t, "launches": n}
        for k in keys:
            total[k] += n * t[k]
        phase("kernels", f"helium prefill q4_wgmma {din}x{dout} M={M} bf16 ({n} a prefill): "
              f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.matmul on bf16 "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({by})")
        del copies, dense
    total["bound_by"] = "operations" if bound_by == {"operations"} else "bytes"
    total["tflops"] = 2 * M * sum(n * din * dout for (din, dout), n in
                                  HELIUM_Q4_SHAPES.items()) / total["ms"] / 1e9
    phase("kernels", f"helium prefill ({sum(HELIUM_Q4_SHAPES.values())} q4_wgmma launches, "
          f"M={M}): kernel {total['ms']:.3f} ms ({total['tflops']:.1f} TFLOP/s), plain "
          f"{total['plain_ms']:.3f} ms, torch.matmul on bf16 {total['library_ms']:.3f} ms, "
          f"bound {total['bound_ms']:.3f} ms ({total['bound_by']})")
    free_memory()
    return {"per_prefill": total, "by_shape": by_shape, "max_abs_err": max_abs, "rows": M}


def check_int8_rows(dev, g) -> dict:
    """int8_gemv above 16 rows (one int8_wgmma launch a call) at every
    INT8_SHAPES shape: against the plain version at INT8_CHECK_ROWS, timed
    (operands cold in L2) at INT8_ROWS beside the 16-row int8_mma chunks it
    replaced, the plain version, torch.matmul on the dequantized bf16 weight
    and the bound, summed over the shape table's launches; then int8_linear
    under autograd at 512 rows: one int8_wgmma launch in the forward, the
    output and dX against the plain path's."""
    from moshi_tpu_torch.ops import qmatmul
    from moshi_tpu_torch.utils.quantize import quantize_tensor

    plain = qmatmul.int8_gemv_plain
    keys = ("ms", "chunked_ms", "plain_ms", "library_ms", "bound_ms")
    per_step = {M: dict.fromkeys(keys, 0.0) for M in INT8_ROWS}
    by_shape, max_abs, bound_by = {}, 0.0, {M: set() for M in INT8_ROWS}
    for (din, dout), n in INT8_SHAPES.items():
        name, times, err = int8_rows_times(dev, g, din, dout, INT8_CHECK_ROWS, INT8_ROWS)
        if name != "int8_wgmma":
            raise RuntimeError(f"int8 {din}x{dout} above 16 rows would not run int8_wgmma")
        max_abs = max(max_abs, err)
        for M, t in times.items():
            bound_by[M].add(t["bound_by"])
            by_shape[f"{din}x{dout} M={M}"] = t
            for k in keys:
                per_step[M][k] += n * t[k]
            phase("kernels", f"int8_wgmma {din}x{dout} M={M} bf16 ({t['plan']['splits']} "
                  f"splits): {rows_phrase(t)}")
    for M in INT8_ROWS:
        f = per_step[M]
        f["bound_by"] = "operations" if bound_by[M] == {"operations"} else "bytes"
        phase("kernels", f"int8 above 16 rows, the depformer's {sum(INT8_SHAPES.values())} "
              f"linears at M={M}: int8_wgmma {rows_phrase(f)}")

    din, dout = 1024, 3072
    qt = quantize_tensor(torch.randn(din, dout, device=dev, generator=g) / din ** 0.5)
    x = torch.randn(2, 256, din, device=dev, generator=g).to(torch.bfloat16)
    dy = torch.randn(2, 256, dout, device=dev, generator=g).to(torch.bfloat16)
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    before = read_counts()
    y = qmatmul.int8_linear(xk, qt.q, qt.scale)
    launched = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
    yp = plain(xp.reshape(-1, din), qt.q, qt.scale).reshape(y.shape)
    (dxk,), (dxp,) = torch.autograd.grad(y, xk, dy), torch.autograd.grad(yp, xp, dy)
    err_y, err_dx = rel_err(y, yp), rel_err(dxk, dxp)
    ok = (launched == {"int8_wgmma": 1} and type(y.grad_fn).__name__ == "FrozenLinearBackward"
          and err_y <= BOUNDS[torch.bfloat16] and err_dx <= BOUNDS[torch.bfloat16])
    phase("kernels", f"int8_linear under autograd, x [2, 256, {din}] -> {dout}: launches "
          f"forward {launched}, grad_fn {type(y.grad_fn).__name__}; y max rel err "
          f"{err_y:.3e}, dX max rel err {err_dx:.3e} against the plain path (bound "
          f"{BOUNDS[torch.bfloat16]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("int8_linear under autograd disagrees with the plain path")
    free_memory()
    return {"per_step": per_step, "by_shape": by_shape, "max_abs_err": max_abs,
            "launches_per_step": sum(INT8_SHAPES.values()),
            "autograd": {"rows": 512, "launches": launched, "y_rel_err": err_y,
                         "dx_rel_err": err_dx}}


def launch_floor_ms(dev, g) -> dict:
    """What one launch costs whatever its work: int8_mma and torch.matmul
    on bf16 at the smallest shape int8_mma takes (16 x 64: one block),
    operands hot in L2, at B = 1 and SLOTS, beside a one-element add_."""
    from moshi_tpu_torch.ops.qmatmul import int8_mma
    from moshi_tpu_torch.utils.quantize import dequantize, quantize_tensor

    qt = quantize_tensor(torch.randn(16, 64, device=dev, generator=g))
    dense = dequantize(qt.q, qt.scale, torch.bfloat16)
    one = torch.zeros(1, device=dev)
    t = {"add_": time_ms(lambda t_: t_.add_(1), [(one,)])}
    for B in (1, SLOTS):
        x = torch.randn(B, 16, device=dev, generator=g).to(torch.bfloat16)
        t[f"int8_mma B={B}"] = time_ms(int8_mma, [(x, qt.q, qt.scale)])
        t[f"torch.matmul B={B}"] = time_ms(torch.matmul, [(x, dense)])
    phase("kernels", "one launch's floor (16 x 64, operands hot in L2): "
          + ", ".join(f"{k} {v * 1e3:.2f} us" for k, v in t.items()))
    return t


def int8pack_ms(qt, din, dev, g):
    """torch._weight_int8pack_mm at B = SLOTS, where this build of PyTorch
    runs it on CUDA (a yardstick for int8_gemv, never called by the port);
    None where it does not."""
    x = torch.randn(SLOTS, din, device=dev, generator=g).to(torch.bfloat16)
    w = qt.q.t().contiguous()
    s = qt.scale[0].to(torch.bfloat16)
    try:
        torch._weight_int8pack_mm(x, w, s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        phase("kernels", f"torch._weight_int8pack_mm on CUDA: not available ({str(e)[:80]})")
        return None
    return time_ms(torch._weight_int8pack_mm, [(x, w, s)])


def random_int4_cache(g, L, B, Hkv, D, cap_pad, dev):
    """Packed caches with every nibble in [-7, 7], positive bf16 scales."""
    def packed():
        vals = torch.randint(-7, 8, (L, B, Hkv * D // 2, cap_pad, 2), device=dev,
                             generator=g, dtype=torch.int8)
        return (vals[..., 1] << 4) | (vals[..., 0] & 15)

    def scales():
        return (0.01 + 0.2 * torch.rand(L, B, Hkv, cap_pad, device=dev, generator=g)
                ).to(torch.bfloat16)
    return packed(), packed(), scales(), scales()


def check_attention(dev, g) -> dict:
    """decode_attention_int4 against its plain version at B = SLOTS, H = 32,
    D = 128 and 64, cap 3000, layer 5 of 8, with its plan (warps, blocks and
    warps per SM): a ragged mask, then slot 0 with positions 0..99 only and
    slot 1 with every position masked (m must be -1e30 and l = cap); times
    per launch at both head dims beside the plain version,
    scaled_dot_product_attention and the bound (the frame's row: D = 128)."""
    from moshi_tpu_torch.ops import int4_attention as i4
    from moshi_tpu_torch.ops.int4_attention import (decode_attention_int4_stats as k4,
                                                    decode_attention_int4_stats_plain as k4p)

    B, H, cap, L, layer = SLOTS, KV["heads"], KV["cap"], 8, 5
    cap_pad = -(-cap // 128) * 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    warps = i4.plan_warps(B, H, H, cap, sms)
    blocks = i4.attention_blocks(B, H, H)
    phase("kernels", f"decode_attention_int4 B={B} H={H} cap={cap} plan: {blocks} blocks of "
          f"{warps} warps and up to {i4.HEADS_PER_BLOCK} heads, chunks of {i4.CHUNK} "
          f"positions, {blocks / sms:.2f} blocks ({blocks * warps / sms:.1f} warps) per SM on "
          f"{sms} SMs")
    max_abs, row, per_launch = 0.0, {"plan": {"warps": warps, "blocks": blocks,
                                              "warps_per_sm": blocks * warps / sms}}, {}
    for D in (128, 64):
        caches = random_int4_cache(g, L, B, H, D, cap_pad, dev)
        q = torch.randn(B, H, 1, D, device=dev, generator=g).to(torch.bfloat16)
        valid = torch.randint(1, cap + 1, (B,), device=dev, generator=g)
        ragged = ((torch.rand(B, cap, device=dev, generator=g) < 0.9)
                  & (torch.arange(cap, device=dev)[None] < valid[:, None]))
        ragged[:, 0] = True
        # slot 0: a ring in its first 8 s; slot 1: every position masked
        edges = ragged.clone()
        edges[0] = False
        edges[0, :100] = True
        edges[1] = False
        for kind, mask in (("ragged", ragged), ("first100+masked", edges)):
            acc, m, lse = k4(q, layer, *caches, mask)
            torch.cuda.synchronize()
            racc, rm, rl = k4p(q, layer, *caches, mask)
            live = torch.ones(B, dtype=torch.bool, device=dev)
            masked_ok = True
            if kind != "ragged":
                live[1] = False
                masked_ok = bool((m[1] == i4.MASKED).all()) and bool((lse[1] == cap).all())
            err = max(rel_err(acc[live] / lse[live], racc[live] / rl[live]),
                      rel_err(m[live], rm[live]))
            max_abs = max(max_abs, (acc[live] / lse[live] - racc[live] / rl[live]).abs().max()
                          .item())
            ok = err <= ATTN_BOUND and bool(torch.isfinite(acc / lse).all()) and masked_ok
            note = "" if kind == "ragged" else (", fully masked slot: m = -1e30 and l = cap"
                                                if masked_ok else ", fully masked slot WRONG")
            phase("kernels", f"decode_attention_int4 B={B} H={H} D={D} cap={cap} layer={layer} "
                  f"{kind} mask: max rel err of acc/l and m {err:.3e} (bound "
                  f"{ATTN_BOUND:.0e}){note} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("decode_attention_int4 disagrees with its plain version")
        mask = ragged
        ops = [(q, li, *caches, mask) for li in range(L)]
        t = {"ms": time_ms(k4, ops), "plain_ms": time_ms(k4p, ops, iters=4),
             "library_ms": sdpa_dequantized_ms(q, caches, mask)}
        nbytes = (2 * B * H * D // 2 * cap + 2 * 2 * B * H * cap + B * cap + 2 * B * H * D
                  + 4 * B * H * (D + 2))
        t["bound_ms"], row["bound_by"] = bound(nbytes, 4 * B * H * cap * D)
        phase("kernels", f"decode_attention_int4 B={B} H={H} D={D} cap={cap}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"on the dequantized bf16 layer {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB); "
              f"{nbytes / t['ms'] / 1e6:.1f} GB/s, {t['bound_ms'] / t['ms']:.0%} of the bound")
        per_launch[D] = t
        del ops, caches
        free_memory()
    row["per_launch"] = per_launch[KV["head_dim"]]
    row["per_launch_by_head_dim"] = per_launch
    row["max_abs_err"] = max_abs
    return row


def sdpa_dequantized_ms(q, caches, mask) -> float:
    """Time of scaled_dot_product_attention of q [B, H, 1, D] over layers 0
    and 1 of the packed int4 caches, dequantized to bf16 beforehand (the
    library call for K4's work; the port never calls it)."""
    import torch.nn.functional as F

    from moshi_tpu_torch.ops.int4_attention import _dequant_layer

    cap = mask.shape[-1]

    def dense(li):
        return [_dequant_layer(c[li], s[li], cap).transpose(-1, -2).to(torch.bfloat16)
                .contiguous() for c, s in ((caches[0], caches[2]), (caches[1], caches[3]))]
    lib_ops = [(q, *dense(li), mask[:, None, None, :]) for li in range(2)]
    return time_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=m_), lib_ops)


def main_path_rows(g, B, Hkv, D, dev):
    """Current rows as the int4 step passes them: kk contiguous, vv a view
    of a qkv-like [B, 3 * Hkv * D] tensor (its slots 3 * Hkv * D apart)."""
    kk = torch.randn(B, Hkv, D, device=dev, generator=g).to(torch.bfloat16)
    qkv = torch.randn(B, 3 * Hkv * D, device=dev, generator=g).to(torch.bfloat16)
    return kk, qkv[:, Hkv * D:2 * Hkv * D].view(B, Hkv, D)


def check_fused_write(dev, g) -> dict:
    """decode_attention_int4_write, the attention whose launch also writes
    the layer's new column, at the batched path's shape (L = 32, B = SLOTS,
    H = Hkv = 32, cap 3000), D = 128 and 64, and at the tts path's (L = 48,
    cap 1000, D = 64), layer 5, over two launches as
    two frames of the ring: slots 0-3 at lanes 0, 63, 64 and cap - 1, slot
    2 frozen (its second write lands on its first's lane), slot 4 with
    every position masked, the second launch attending the lanes the first
    wrote.  After each launch the four caches must equal, byte for byte,
    the plain quantization of the rows on the card written by
    cache_write_int4_plain into a copy of the caches (so every other byte
    is unchanged), and the stats must be within ATTN_BOUND of the plain
    version's; two calls on copies of one cache must give the same bits.
    The plain quantization on the card must give the bytes and scales of
    the rows' CPU copies (the JAX package's).  Then, on the same operands,
    the fused launch's time beside the attention alone: their difference
    is the write's cost."""
    from moshi_tpu_torch.ops import int4_attention as i4

    k4w, k4 = i4.decode_attention_int4_write, i4.decode_attention_int4_stats
    B, H, layer = SLOTS, KV["heads"], 5
    frozen, masked = 2, 4
    max_abs, per_launch = 0.0, {}
    cases = [("moshi", KV["layers"], KV["cap"], 128), ("moshi", KV["layers"], KV["cap"], 64),
             ("tts", TTS_KV["layers"], TTS_KV["cap"], TTS_KV["head_dim"])]
    for path, L, cap, D in cases:
        cap_pad = -(-cap // 128) * 128
        lanes = torch.arange(cap, device=dev)[None]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = {"warps": i4.plan_warps(B, H, H, cap, sms), "blocks": i4.attention_blocks(B, H, H)}
        plan["warps_per_sm"] = plan["blocks"] * plan["warps"] / sms
        phase("kernels", f"decode_attention_int4_write {path} L={L} B={B} H={H} D={D} cap={cap} "
              f"(cap_pad {cap_pad}) plan: {plan['blocks']} blocks of {plan['warps']} warps, "
              f"{plan['warps_per_sm']:.1f} warps per SM on {sms} SMs")
        caches = random_int4_cache(g, L, B, H, D, cap_pad, dev)
        expected = [c.clone() for c in caches]
        pos = torch.cat([torch.tensor([0, 63, 64, cap - 1], device=dev),
                         torch.randint(0, cap, (B - 4,), device=dev, generator=g)])
        card_vs_cpu = 0
        for step in range(2):
            if step:
                pos = torch.where(torch.arange(B, device=dev) == frozen, pos, (pos + 1) % cap)
            # each slot's ring holds its lanes below the write lane and, from
            # an earlier lap, its last 100
            mask = ((lanes < pos[:, None]) | (lanes >= cap - 100)) & (lanes != pos[:, None])
            mask[masked] = False
            q = torch.randn(B, H, 1, D, device=dev, generator=g).to(torch.bfloat16)
            kk, vv = main_path_rows(g, B, H, D, dev)
            racc, rm, rl = i4.decode_attention_int4_stats_plain(q, layer, *expected, mask)
            cols = i4.int4_columns(kk, vv)
            card_vs_cpu += sum(int((a.cpu() != b).sum())
                               for a, b in zip(cols, i4.int4_columns(kk.cpu(), vv.cpu())))
            i4.cache_write_int4_plain(pos, *cols, *(e[layer:layer + 1] for e in expected))
            acc, m, lse = k4w(q, kk, vv, pos, layer, *caches, mask)
            torch.cuda.synchronize()
            equal = all(torch.equal(c, e) for c, e in zip(caches, expected))
            live = torch.arange(B, device=dev) != masked
            err = max(rel_err(acc[live] / lse[live], racc[live] / rl[live]),
                      rel_err(m[live], rm[live]))
            max_abs = max(max_abs, (acc[live] / lse[live] - racc[live] / rl[live]).abs().max()
                          .item())
            masked_ok = bool((m[masked] == i4.MASKED).all()) and bool((lse[masked] == cap).all())
            ok = equal and err <= ATTN_BOUND and masked_ok and bool(torch.isfinite(acc).all())
            phase("kernels", f"decode_attention_int4_write L={L} B={B} H={H} D={D} cap={cap} "
                  f"layer={layer} frame {step + 1} (lanes {pos[:5].tolist()}, slot {frozen} "
                  f"frozen, slot {masked} fully masked): caches "
                  f"{'byte-equal to the plain write' if equal else 'DIFFER'}, max rel err of "
                  f"acc/l and m {err:.3e} (bound {ATTN_BOUND:.0e}), fully masked slot "
                  f"{'m = -1e30 and l = cap' if masked_ok else 'WRONG'} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("decode_attention_int4_write disagrees with its plain version")
        phase("kernels", f"decode_attention_int4_write D={D}: the plain quantization on the "
              f"card differs from the CPU's in {card_vs_cpu} column bytes and scales over the "
              f"two frames {'ok' if card_vs_cpu == 0 else 'FAIL'}")
        if card_vs_cpu:
            raise RuntimeError("the plain int4 quantization on the card is not the CPU's")
        del expected
        small = random_int4_cache(g, 2, B, H, D, cap_pad, dev)
        runs = []
        for _ in range(2):
            copy = [c.clone() for c in small]
            runs.append(k4w(q, kk, vv, pos, 1, *copy, mask) + tuple(copy))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        phase("kernels", f"decode_attention_int4_write D={D}: two calls on copies of one cache "
              f"(slot {masked} fully masked) give {'the same bits' if same else 'OTHER BITS'}")
        if not same:
            raise RuntimeError("decode_attention_int4_write is not deterministic")
        del small, runs

        ops_w = [(q, kk, vv, pos, li, *caches, mask) for li in range(L)]
        ops_s = [(q, li, *caches, mask) for li in range(L)]
        # in turns after a discarded reading: the first timing after the
        # checks read ~6 us high in three calls out of three
        time_ms(k4w, ops_w)
        fused = [time_ms(k4w, ops_w)]
        alone = [time_ms(k4, ops_s), time_ms(k4, ops_s)]
        fused.append(time_ms(k4w, ops_w))
        t_fused, t_alone = sum(fused) / 2, sum(alone) / 2
        cols = i4.int4_columns(kk, vv)
        bi, pi = torch.arange(B, device=dev)[:, None], pos[:, None]

        def write_plain(kk_, vv_, pos_, li, k_all, v_all, ks_all, vs_all):
            at = slice(li, li + 1)
            i4.cache_write_int4_plain(pos_, *i4.int4_columns(kk_, vv_), k_all[at], v_all[at],
                                      ks_all[at], vs_all[at])

        def index_put(li, k_all, v_all, ks_all, vs_all):
            for col, cache in zip(cols, (k_all, v_all, ks_all, vs_all)):
                ri = torch.arange(col.shape[-1], device=dev)[None]
                cache[li].index_put_((bi, ri, pi), col[0])
        write_ops = [(kk, vv, pos, li, *caches) for li in range(L)]
        write_bytes = 2 * B * H * D * 2 + 8 * B + 2 * B * H * D // 2 + 2 * 2 * B * H
        attn_bytes = (2 * B * H * D // 2 * cap + 2 * 2 * B * H * cap + B * cap + 2 * B * H * D
                      + 4 * B * H * (D + 2))
        write = {"ms": t_fused - t_alone, "plain_ms": time_ms(write_plain, write_ops),
                 "library_ms": time_ms(index_put, [(li, *caches) for li in range(L)])}
        write["bound_ms"], _ = bound(write_bytes, 0)
        k4_row = {"ms": t_fused, "attention_alone_ms": t_alone,
                  "plain_ms": time_ms(i4.decode_attention_int4_write_plain, ops_w, iters=4),
                  "library_ms": sdpa_dequantized_ms(q, caches, mask)}
        k4_row["bound_ms"], _ = bound(attn_bytes + write_bytes, 4 * B * H * cap * D)
        phase("kernels", f"decode_attention_int4_write B={B} H={H} D={D} cap={cap}: fused "
              f"launch {fused[0]:.4f} / {fused[1]:.4f} ms (scaled_dot_product_attention on "
              f"the dequantized bf16 layer {k4_row['library_ms']:.4f} ms, bound "
              f"{k4_row['bound_ms']:.4f} ms), the attention alone "
              f"{alone[0]:.4f} / {alone[1]:.4f} ms: the write costs "
              f"{write['ms'] * 1e3:.2f} us per launch, {write['ms'] * L:.4f} ms per frame "
              f"({L} launches; bound {write['bound_ms'] * L:.5f} ms, "
              f"{write_bytes * L / 1e6:.2f} MB read + written; the plain write "
              f"{write['plain_ms'] * L:.3f} ms, index_put_ of the packed columns into the 4 "
              f"caches {write['library_ms'] * L:.3f} ms); earlier designs (PERF.md): the "
              f"standalone cache_write_int4 {EARLIER_MS['cache_write_int4 per frame']} ms per "
              f"frame, the attention {EARLIER_MS['decode_attention_int4 per launch']} ms per "
              f"launch")
        per_launch[f"{path} L={L} cap={cap} D={D}"] = {"write": write, "k4": k4_row,
                                                       "plan": plan}
        del ops_w, ops_s, write_ops, caches
        free_memory()
    at_d = per_launch[f"moshi L={KV['layers']} cap={KV['cap']} D={KV['head_dim']}"]
    tts = per_launch[f"tts L={TTS_KV['layers']} cap={TTS_KV['cap']} D={TTS_KV['head_dim']}"]
    return {"per_launch": at_d["write"], "k4_per_launch": at_d["k4"],
            "tts_per_launch": tts["write"], "tts_k4_per_launch": tts["k4"],
            "per_launch_by_case": per_launch, "bound_by": "bytes", "max_abs_err": 0.0,
            "stats_max_abs_err": max_abs}


def random_int8_cache(g, L, B, cap, Hkv, D, dev):
    """int8 ring caches [L, B, cap, Hkv, D] and positive bf16 row scales."""
    def vals():
        return torch.randint(-127, 128, (L, B, cap, Hkv, D), device=dev, generator=g,
                             dtype=torch.int8)

    def scales():
        return (0.001 + 0.02 * torch.rand(L, B, cap, Hkv, 1, device=dev, generator=g)
                ).to(torch.bfloat16)
    return vals(), vals(), scales(), scales()


def check_attention_int8(dev, g) -> dict:
    """decode_attention_int8 against its plain version at the main paths'
    shapes (INT8_KV), D = 128 and 64 (the TTS shape at its D = 64), layer
    3 of 4, a ragged mask and slot 0 with every position masked (which must
    give 0); times per launch at each path's head dim beside
    scaled_dot_product_attention on the dequantized bf16 layer and the
    bound."""
    import torch.nn.functional as F

    from moshi_tpu_torch.ops import decode_attention as da
    from moshi_tpu_torch.ops.decode_attention import (decode_attention_int8 as k6,
                                                      decode_attention_int8_plain as k6p)

    L, layer = 4, 3
    max_abs, per_launch, bound_by, plans = 0.0, {}, None, {}
    for path, (B, H, cap) in INT8_KV.items():
        timed_d = TTS_KV["head_dim"] if path == "tts" else 128  # the path's head dim
        for D in (64,) if path == "tts" else (128, 64):
            caches = random_int8_cache(g, L, B, cap, H, D, dev)
            q = torch.randn(B, H, D, device=dev, generator=g).to(torch.bfloat16)
            valid = torch.randint(1, cap + 1, (B,), device=dev, generator=g)
            ragged = ((torch.rand(B, cap, device=dev, generator=g) < 0.9)
                      & (torch.arange(cap, device=dev)[None] < valid[:, None]))
            ragged[:, 0] = True
            # the Moshi ring's first 8 s: only positions 0..99 masked in, so
            # every later split holds none
            first100 = torch.zeros(B, cap, dtype=torch.bool, device=dev)
            first100[:, :100] = True
            masks = {"ragged": ragged, **({"first100": first100} if path == "moshi_b16" else {})}
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            splits, per, warps = da.plan_splits(B, H, D, cap, sms)
            blocks = B * -(-H // da.heads_per_block(D)) * splits
            plans[f"{path} D={D}"] = {"splits": splits, "cluster": splits, "per_split": per,
                                      "warps": warps, "blocks": blocks,
                                      "blocks_per_sm": blocks / sms}
            phase("kernels", f"decode_attention_int8 {path} B={B} H={H} D={D} cap={cap} plan: "
                  f"{splits} splits of {per} positions (clusters of {splits} blocks), "
                  f"{blocks} blocks of {warps} warps and {da.heads_per_block(D)} heads, "
                  f"{blocks / sms:.2f} blocks ({blocks * warps / sms:.1f} warps) per SM on "
                  f"{sms} SMs")
            for kind, mask in masks.items():
                mask[0] = False
                out = k6(q, layer, *caches, mask)
                torch.cuda.synchronize()
                ref = k6p(q, layer, *caches, mask)
                err = rel_err(out[1:], ref[1:])
                max_abs = max(max_abs, (out.float() - ref.float()).abs().max().item())
                ok = (err <= ATTN_BOUND and bool(torch.isfinite(out).all())
                      and bool((out[0] == 0).all()))
                phase("kernels", f"decode_attention_int8 B={B} H={H} D={D} cap={cap} "
                      f"layer={layer} {kind} mask: max rel err {err:.3e} (bound "
                      f"{ATTN_BOUND:.0e}), fully masked slot "
                      f"{'0' if (out[0] == 0).all() else 'NOT 0'} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError("decode_attention_int8 disagrees with its plain version")
            mask = ragged
            if D != timed_d:
                continue
            ops = [(q, li, *caches, mask) for li in range(L)]
            t = {"ms": time_ms(k6, ops), "plain_ms": time_ms(k6p, ops, iters=4)}

            def dense(li):
                return [(c[li].float() * s[li].float()).to(torch.bfloat16).transpose(1, 2)
                        .contiguous() for c, s in ((caches[0], caches[2]),
                                                   (caches[1], caches[3]))]
            lib_ops = [(q[:, :, None], *dense(li), mask[:, None, None, :]) for li in range(2)]
            t["library_ms"] = time_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(
                q_, k_, v_, attn_mask=m_), lib_ops)
            nbytes = 2 * B * cap * H * D + 2 * 2 * B * cap * H + B * cap + 2 * 2 * B * H * D
            t["bound_ms"], bound_by = bound(nbytes, 4 * B * H * cap * D)
            phase("kernels", f"decode_attention_int8 {path} B={B} H={H} D={D} cap={cap}: "
                  f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"scaled_dot_product_attention on the dequantized bf16 layer "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB); {nbytes / t['ms'] / 1e6:.1f} GB/s")
            per_launch[path] = t
            del ops, lib_ops
        del caches
        free_memory()
    return {"per_launch": per_launch["asr"], "per_launch_by_shape": per_launch,
            "bound_by": bound_by, "max_abs_err": max_abs, "plans": plans}


# ------------------------------------------------------------------ slice
def per_step_launches(cfg, params, batch: int, q4_shapes=Q4_SHAPES,
                      int8_shapes=INT8_SHAPES) -> dict:
    """Kernel launches one LMGen.step of `batch` slots implies: each q4
    temporal linear once per layer plus the text head, each on the kernel
    that q4matmul.route picks for bf16 x of `batch` rows; each int8
    depformer linear once per layer and codebook, plus depformer_in and the
    output head per codebook, each on the kernel that qmatmul.route picks
    (int8_route); with the int4 KV cache, one decode_attention_int4 per
    layer, each writing its layer's column (counted as cache_write_int4
    too); with the int8 KV cache, one decode_attention_int8 per layer."""
    from moshi_tpu_torch.ops import q4matmul
    from moshi_tpu_torch.utils.quantize import QTensor, QTensor4

    layers = params["transformer"]["layers"]
    temporal = [layers["attn"]["in_proj"], layers["attn"]["out_proj"],
                layers["mlp"]["linear_in"], layers["mlp"]["linear_out"]]
    dlayers = params["depformer"]["layers"]
    dep = [dlayers["attn"]["in_proj"], dlayers["attn"]["out_proj"],
           dlayers["mlp"]["linear_in"], dlayers["mlp"]["linear_out"]]
    kinds = ([isinstance(w, QTensor4) for w in temporal + [params["text_linear"]["weight"]]]
             + [isinstance(w, QTensor) for w in dep + [params["depformer_in"]["weight"],
                                                       params["linears"]["weight"]]])
    if not all(kinds):
        raise RuntimeError("the quantized tree is not q4 temporal / int8 depformer")
    per_step = dict.fromkeys(TPU_KERNELS, 0)
    for w, n in [(w, cfg.num_layers) for w in temporal] + [(params["text_linear"]["weight"], 1)]:
        dout = w.q.shape[-1]
        gs = 2 * w.q.shape[-2] // w.scale.shape[-3]
        per_step[q4matmul.route(batch, torch.bfloat16, gs, dout)] += n
    for w, n in ([(w, cfg.depformer_num_layers * cfg.dep_q) for w in dep]
                 + [(params["depformer_in"]["weight"], cfg.dep_q),
                    (params["linears"]["weight"], cfg.dep_q)]):
        name, launches = int8_route(batch, *w.q.shape[-2:])
        per_step[name] += n * launches
    if (per_step["q4_gemv"] + per_step["q4_mma"] + per_step["q4_wgmma"]
            != sum(q4_shapes.values())
            or per_step["int8_gemv"] + per_step["int8_mma"] + per_step["int8_wgmma"]
            != sum(int8_shapes.values())):
        raise RuntimeError(f"launches per step {per_step} do not match the shape tables")
    int4 = cfg.kv_cache_dtype == "int4"
    per_step["decode_attention_int4"] = cfg.num_layers if int4 else 0
    per_step["cache_write_int4"] = cfg.num_layers if int4 else 0
    per_step["decode_attention_int8"] = cfg.num_layers if cfg.kv_cache_dtype == "int8" else 0
    return per_step


def int8_route(rows: int, din: int, dout: int) -> tuple[str, int]:
    """The kernel a bf16 int8 linear of `rows` rows launches
    (qmatmul.route, q 16-byte aligned as every main path's weights are) and
    its launches a call: one int8_wgmma launch, else one per 16 rows."""
    from moshi_tpu_torch.ops import qmatmul

    name = qmatmul.route(rows, torch.bfloat16, din, dout, True)
    return name, 1 if name == "int8_wgmma" else -(-rows // 16)


def counters() -> dict:
    """The launch-counted wrappers, by kernel name: decode_attention_int4
    counts every launch of that kernel, cache_write_int4 those that write."""
    from moshi_tpu_torch.ops.decode_attention import decode_attention_int8
    from moshi_tpu_torch.ops.int4_attention import (decode_attention_int4_stats,
                                                    decode_attention_int4_write)
    from moshi_tpu_torch.ops.q4matmul import q4_gemv, q4_mma, q4_wgmma
    from moshi_tpu_torch.ops.qmatmul import int8_gemv, int8_mma, int8_wgmma
    return {"q4_gemv": q4_gemv, "q4_mma": q4_mma, "q4_wgmma": q4_wgmma, "int8_gemv": int8_gemv,
            "int8_mma": int8_mma, "int8_wgmma": int8_wgmma,
            "decode_attention_int4": decode_attention_int4_stats,
            "cache_write_int4": decode_attention_int4_write,
            "decode_attention_int8": decode_attention_int8}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters().items()}


def check_counts(launches: dict, expected: dict, steps: int, what: str) -> None:
    for name, n in launches.items():
        if n != expected[name] * steps:
            raise RuntimeError(f"{what}: {name} launched {n} times, expected "
                               f"{expected[name]} x {steps}")


def used(counts: dict) -> dict:
    """The kernels of a launch count that ran."""
    return {k: v for k, v in counts.items() if v}


def check_tokens(tokens, cfg, what: str) -> None:
    if not ((tokens[:, 0] >= 0).all() and (tokens[:, 0] < cfg.text_card).all()
            and (tokens[:, 1:] >= 0).all() and (tokens[:, 1:] < cfg.card).all()):
        raise RuntimeError(f"{what}: token out of range")


def check_pcm(audio, frame_size, what: str) -> None:
    if not all(p.shape == (frame_size,) and np.isfinite(p).all() for p in audio):
        raise RuntimeError(f"{what}: PCM frames of the wrong size or not finite")


def build_models(dev):
    from moshi_tpu_torch.models.lm import LMModel, lm_config_v0_1
    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config
    from moshi_tpu_torch.utils.quantize import quantize_lm_params

    t0 = time.perf_counter()
    cfg = lm_config_v0_1()
    lm = LMModel(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED)
    lm_params = quantize_lm_params(lm.init_params(g, torch.bfloat16, dev), mode="int4")
    free_memory()
    mimi = MimiModel(mimi_v0_1_config(cfg.dep_q))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    torch.cuda.synchronize()
    phase("slice", f"Moshi-7B q4 + Mimi bf16 built from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
          f"GiB on the card")
    return lm, lm_params, mimi, mimi_params


def run_slice(dev, card: str, lm, lm_params, mimi, mimi_params) -> dict:
    """ServerState (B = 1) as the server runs it on the card: warm-up, then
    SESSIONS of FRAMES frames, each frame replays of the three graphs
    captured at its first frame (encode, LMGen.step, decode); launch counts
    from the captured step; a profiler pass over 5 graphed frames; then one
    session of the same path eagerly, for the comparison."""
    from moshi_tpu_torch.serve.server import ServerState, serve_sessions

    cfg = lm.config
    expected = per_step_launches(cfg, lm_params, 1)
    if expected["q4_mma"]:
        raise RuntimeError(f"the B = 1 frame would run q4_mma: {expected}")
    state = ServerState(mimi, mimi_params, lm, lm_params, device=dev)
    if not state.graphed:
        raise RuntimeError("ServerState on the card is not graphed")
    state.warmup()
    torch.cuda.synchronize()

    zero_counts()
    results = serve_sessions(state, SESSIONS, FRAMES)
    launches = read_counts()

    steps = len(SESSIONS) * FRAMES
    check_counts(launches, expected, 1, "slice (the captured LMGen.step)")
    replays = {name: getattr(state, name).replays for name in ("encode", "step", "decode")}
    generated = len(SESSIONS) * (FRAMES - cfg.max_delay)
    if replays != {"encode": steps, "step": steps, "decode": generated}:
        raise RuntimeError(f"slice: replays {replays}")
    for i, (tokens, audio, _) in enumerate(results):
        if len(tokens) != FRAMES - cfg.max_delay:
            raise RuntimeError(f"session {i}: {len(tokens)} frames generated")
        check_pcm(audio, mimi.frame_size, f"session {i}")
        check_tokens(tokens, cfg, f"session {i}")
    if not np.array_equal(results[0][0], results[2][0]):
        raise RuntimeError("sessions 1 and 3 share a seed but not their tokens")
    if np.array_equal(results[0][0], results[1][0]):
        raise RuntimeError("sessions 1 and 2 have different seeds but equal tokens")
    ms = np.concatenate([r[2] for r in results])
    p50, p90 = (float(np.percentile(ms, p)) for p in (50, 90))
    phase("slice", f"graphed, {len(SESSIONS)} sessions x {FRAMES} frames: launches {launches} "
          f"= per step {expected} x 1 captured step; replays {replays}; sessions 1 and 3 "
          f"identical, 1 and 2 not; p50 {p50:.2f} ms/frame, p90 {p90:.2f} ms/frame ({card})")
    pcm = (0.1 * np.random.RandomState(SEED + 6).randn(5, mimi.frame_size)).astype(np.float32)
    prof = profile_frames(lambda i: state.step_frame(pcm[i]), len(pcm))
    prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / p50
    phase("slice", f"profiler over 5 graphed frames: {profile_line(prof)}")
    del state
    free_memory()

    eager = ServerState(mimi, mimi_params, lm, lm_params, device=dev, graphed=False)
    eager.warmup()
    zero_counts()
    (tokens, _, ems), = serve_sessions(eager, SESSIONS[:1], FRAMES)
    eager_launches = read_counts()
    check_counts(eager_launches, expected, FRAMES, "slice, eager")
    same = np.array_equal(tokens, results[0][0])
    e50, e90 = (float(np.percentile(ems, p)) for p in (50, 90))
    phase("slice", f"eager, 1 session x {FRAMES} frames: p50 {e50:.2f} ms/frame, p90 "
          f"{e90:.2f} ms/frame; launches {eager_launches}; its sampled tokens "
          f"{'equal' if same else 'DIFFER from'} the graphed session's of the same seed")
    del eager
    free_memory()
    return {"launches": launches, "replays": replays, "p50_ms": p50, "p90_ms": p90,
            "profile": prof, "eager": {"p50_ms": e50, "p90_ms": e90, "frames": len(ems),
                                       "launches": eager_launches,
                                       "sampled_tokens_equal_graphed": same}}


# ------------------------------------------------------------------ serve
SERVE_DIR = ROOT / "build" / "serve_checkpoint"
SERVE_FRAMES = 40        # frames of seeded noise a session
SERVE_QUEUED_FRAMES = 8  # the queued client's session
SERVE_QUEUE_AT = 5       # the frame of session 1 at which the second client connects
SERVE_TIMEOUT = 120      # seconds a client waits for a message
# the checkpoint's lm_gen_config: greedy, so session 1 can be held against
# the in-memory weights token for token
SERVE_GREEDY = {"temp": 0.0, "temp_text": 0.0}
SAMPLED = {"text_temperature": "0.7", "audio_temperature": "0.8"}
# session queries: 1 greedy, 2 and 3 sampled with one seed, 4 with another
SERVE_SESSIONS = ({}, {**SAMPLED, "text_seed": "5"}, {**SAMPLED, "text_seed": "5"},
                  {**SAMPLED, "text_seed": "6"})
SERVE_QUEUED = {"text_temperature": "0.7"}


def same_tree(got, want, path: str = "") -> int:
    """Raise unless `got` has `want`'s structure, leaf classes, dtypes,
    devices and bytes; returns the number of tensors compared."""
    from moshi_tpu_torch.utils.quantize import QTensor, QTensor4

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise RuntimeError(f"serve: the loaded tree's keys differ at {path or '/'}")
        return sum(same_tree(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise RuntimeError(f"serve: the loaded tree's lists differ at {path}")
        return sum(same_tree(g, w, f"{path}/{i}") for i, (g, w) in enumerate(zip(got, want)))
    if isinstance(want, (QTensor, QTensor4)):
        if type(got) is not type(want):
            raise RuntimeError(f"serve: {path} loaded as {type(got).__name__}, "
                               f"written as {type(want).__name__}")
        return same_tree(got.q, want.q, path + "#q") + same_tree(got.scale, want.scale,
                                                                  path + "#scale")
    if not (isinstance(got, torch.Tensor) and got.dtype == want.dtype
            and got.device == want.device and torch.equal(got, want)):
        raise RuntimeError(f"serve: the loaded leaf {path} differs from the written one")
    return 1


def write_checkpoint(lm, lm_params, mimi, mimi_params, out: Path) -> int:
    """A native checkpoint directory of the weights, as the port writes it:
    the q4 LM, Mimi, a config.json of the LM's fields with a greedy
    lm_gen_config and a synthetic SentencePiece tokenizer of the text
    vocabulary.  Returns the bytes of the weights."""
    import dataclasses
    from moshi_tpu_torch.models.native_ckpt import save_mimi_params, save_params
    from moshi_tpu_torch.text.spm import spm_model_bytes

    out.mkdir(parents=True)
    nbytes = save_params(out / "model.q4.native.safetensors", lm_params)
    nbytes += save_mimi_params(out / "mimi.native.safetensors", mimi, mimi_params)
    (out / "tokenizer_spm_32k_3.model").write_bytes(spm_model_bytes(lm.config.text_card))
    config = {k: list(v) if isinstance(v, tuple) else v
              for k, v in dataclasses.asdict(lm.config).items()}
    config.update(moshi_name="model.q4.native.safetensors", mimi_name="mimi.native.safetensors",
                  tokenizer_name="tokenizer_spm_32k_3.model", model_type="moshi",
                  native_format=True, lm_gen_config=SERVE_GREEDY)
    (out / "config.json").write_text(json.dumps(config, indent=2))
    return nbytes


def serve_pcm(frame_size: int) -> np.ndarray:
    """The PCM every [serve] session sends: SERVE_FRAMES frames of seeded
    noise."""
    return (0.3 * np.random.RandomState(SEED + 40).randn(SERVE_FRAMES, frame_size)
            ).astype(np.float32)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def frames_session(ws, pcm, on_frame=None) -> tuple[list, list]:
    """Raw PCM over an open session: the {"raw_pcm": true} metadata, then
    each frame followed by a ping, its replies read up to the ping
    (`on_frame(i)` awaited before frame i).  Returns (the replies to each
    frame but the ping, ms from each frame sent to its PCM reply or None)."""
    from moshi_tpu_torch.serve import protocol as proto

    await ws.send_bytes(proto.msg(proto.MT_METADATA, json.dumps({"raw_pcm": True}).encode()))
    reply = json.loads((await ws.receive_bytes(timeout=SERVE_TIMEOUT))[1:])
    if not reply.get("raw_pcm"):
        raise RuntimeError(f"serve: raw PCM refused: {reply}")
    replies, ms = [], []
    for i, frame in enumerate(pcm):
        if on_frame is not None:
            await on_frame(i)
        t0 = time.perf_counter()
        await ws.send_bytes(proto.msg(proto.MT_PCM, frame.tobytes()))
        await ws.send_bytes(proto.msg(proto.MT_PING))
        got, t = [], None
        while (m := await ws.receive_bytes(timeout=SERVE_TIMEOUT))[0] != proto.MT_PING:
            if m[0] == proto.MT_PCM:
                t = (time.perf_counter() - t0) * 1e3
            got.append(m)
        replies.append(got)
        ms.append(t)
    return replies, ms


async def pcm_session(ws, pcm, on_frame=None) -> tuple[list, list]:
    """frames_session's replies in one list, and the ms of the frames that
    had a PCM reply."""
    replies, ms = await frames_session(ws, pcm, on_frame)
    return [m for r in replies for m in r], [t for t in ms if t is not None]


async def drive_server(state, expected: dict) -> dict:
    """The server app on 127.0.0.1 and its clients: SERVE_SESSIONS, each
    sending serve_pcm, with a second client queueing during session 1
    (SERVE_QUEUED).  Checks the launches at three points: the first
    captured step (exactly `expected`), after the queued session (its
    override set's two warm-up steps and its capture on top) and at the
    end (the sampled override set likewise)."""
    import aiohttp
    from aiohttp import web
    from moshi_tpu_torch.serve import protocol as proto
    from moshi_tpu_torch.serve.server import make_app

    runner = web.AppRunner(make_app(state))
    await runner.setup()
    port = free_port()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    url = f"http://127.0.0.1:{port}/api/chat"
    pcm = serve_pcm(state.frame_size)
    out = {"sessions": [], "ms": [], "checks": {}}
    try:
        async with aiohttp.ClientSession() as http:
            async def open_session(query):
                ws = await http.ws_connect(url, params=query)
                first = await ws.receive_bytes(timeout=SERVE_TIMEOUT)
                waits = []
                while first[0] == proto.MT_METADATA:  # queue positions
                    waits.append(json.loads(first[1:]))
                    first = await ws.receive_bytes(timeout=SERVE_TIMEOUT)
                if first != proto.handshake():
                    raise RuntimeError(f"serve: handshake {first!r}")
                echo = (json.loads((await ws.receive_bytes(timeout=SERVE_TIMEOUT))[1:])
                        if query else None)
                return ws, waits, echo

            async def queued_client():
                ws, waits, echo = await open_session(SERVE_QUEUED)
                msgs, _ = await pcm_session(ws, pcm[:SERVE_QUEUED_FRAMES])
                await ws.close()
                return waits, echo, msgs

            queued = None

            async def on_frame(i):
                nonlocal queued
                if i == 2:  # the frame after the first captured step
                    out["checks"]["first_capture"] = read_counts()
                if i == SERVE_QUEUE_AT:
                    queued = asyncio.ensure_future(queued_client())
                    while not state._session_order[1:]:  # until it waits in the queue
                        if queued.done():
                            queued.result()
                            raise RuntimeError("serve: the second client never queued")
                        await asyncio.sleep(0.01)

            for n, query in enumerate(SERVE_SESSIONS):
                ws, waits, echo = await open_session(query)
                if waits:
                    raise RuntimeError(f"serve: session {n + 1} waited: {waits}")
                msgs, ms = await pcm_session(ws, pcm, on_frame if n == 0 else None)
                if n == 0:
                    out["greedy_tokens"] = np.array(state.session_tokens)
                await ws.close()
                if n == 0:
                    waits, qecho, qmsgs = await queued
                    if (not waits or waits[0] != {"status": "wait", "queue_position": 1}
                            or qecho["text_temperature"] != 0.7):
                        raise RuntimeError(f"serve: queued client got {waits}, {qecho}")
                    generated = SERVE_QUEUED_FRAMES - 1 - state.lm.config.max_delay
                    if sum(m[0] == proto.MT_PCM for m in qmsgs) != generated:
                        raise RuntimeError("serve: the queued client's session is short")
                    out["queued"] = {"queue_messages": len(waits), "frames": SERVE_QUEUED_FRAMES}
                    out["checks"]["after_queued"] = read_counts()
                out["sessions"].append({"query": query, "echo": echo, "msgs": msgs})
                out["ms"] += ms
            out["checks"]["end"] = read_counts()
    finally:
        await runner.cleanup()
    return out


def run_serve(dev, card: str, lm, lm_params, mimi, mimi_params, slice_p50: float) -> dict:
    """The server's entry point over a checkpoint the port wrote: the
    weights of build_models saved with save_params, loaded back through
    load_state (CheckpointInfo, as `main` does) and held leaf for leaf
    against the written ones, warmed up, served over aiohttp on 127.0.0.1
    to raw-PCM clients (SERVE_SESSIONS and a queued one); session 1's greedy
    tokens against a ServerState on the in-memory weights fed the same
    PCM; p50/p90 ms from a frame sent to its PCM reply.  The checkpoint
    stays in SERVE_DIR for [worker], which deletes it (so does a failure
    here)."""
    import shutil
    import aiohttp
    from moshi_tpu_torch.serve import protocol as proto
    from moshi_tpu_torch.serve.server import ServerState, load_state

    expected = per_step_launches(lm.config, lm_params, 1)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = write_checkpoint(lm, lm_params, mimi, mimi_params, SERVE_DIR)
        write_s = time.perf_counter() - t0
        phase("serve", f"wrote a native checkpoint: {nbytes / 1e9:.3f} GB of weights in "
              f"{write_s:.2f} s -> {SERVE_DIR}")
        t0 = time.perf_counter()
        state = load_state(SERVE_DIR, dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        leaves = same_tree(state.lm_params, lm_params) + same_tree(state.mimi_params,
                                                                   mimi_params)
        if state.lm.config != lm.config or state.mimi.config != mimi.config:
            raise RuntimeError("serve: the loaded configs differ from the written ones")
        phase("serve", f"load_state (CheckpointInfo.from_dir, get_mimi, get_moshi onto the "
              f"card, the tokenizer, the engine) {load_s:.2f} s, {nbytes / 1e9 / load_s:.2f} "
              f"GB/s; {leaves} tensors torch.equal to the written ones, classes and dtypes "
              f"included ({card})")
        if per_step_launches(state.lm.config, state.lm_params, 1) != expected:
            raise RuntimeError("serve: the loaded tree routes otherwise than the written one")
        state.warmup()
        zero_counts()
        out = asyncio.run(drive_server(state, expected))
        checks = out["checks"]
        for name, key, times in (("the first captured step", "first_capture", 1),
                                 ("after the queued session", "after_queued", 4),
                                 ("the end", "end", 7)):
            check_counts(checks[key], expected, times, f"serve, {name}")
        launches = checks["end"]
        s = out["sessions"]
        if s[1]["msgs"] != s[2]["msgs"]:
            raise RuntimeError("serve: sessions 2 and 3 share a seed but not their messages")
        if s[1]["msgs"] == s[3]["msgs"]:
            raise RuntimeError("serve: sessions 2 and 4 have different seeds but equal messages")
        generated = SERVE_FRAMES - 1 - lm.config.max_delay
        for i, sess in enumerate(s):
            pcm_msgs = [m for m in sess["msgs"] if m[0] == proto.MT_PCM]
            if len(pcm_msgs) != generated:
                raise RuntimeError(f"serve: session {i + 1} sent {len(pcm_msgs)} PCM frames")
            check_pcm([np.frombuffer(m[1:], np.float32) for m in pcm_msgs], mimi.frame_size,
                      f"serve session {i + 1}")
        tokens = out["greedy_tokens"]
        check_tokens(tokens, lm.config, "serve session 1")
        tokenizer = state.text_tokenizer
        pieces = [m[1:].decode() for m in s[0]["msgs"] if m[0] == proto.MT_TEXT]
        del state
        free_memory()

        ref = ServerState(mimi, mimi_params, lm, lm_params, device=dev, **SERVE_GREEDY)
        ref.warmup()
        pcm = serve_pcm(mimi.frame_size)
        ref.skip_frame(pcm[0])
        for chunk in pcm[1:]:
            ref.step_frame(chunk)
        ref_tokens = np.array(ref.session_tokens)
        del ref
        free_memory()
        if not np.array_equal(tokens, ref_tokens):
            raise RuntimeError("serve: session 1's tokens differ from the in-memory weights'")
        ref_pieces = [tokenizer.id_to_piece(int(t)).replace("▁", " ")
                      for t in ref_tokens[:, 0] if t not in (0, 3)]
        if pieces != ref_pieces:
            raise RuntimeError("serve: session 1's text pieces differ from its tokens'")
        p50, p90 = (float(np.percentile(out["ms"], p)) for p in (50, 90))
        phase("serve", f"aiohttp {aiohttp.__version__} on 127.0.0.1, raw PCM: "
              f"{len(SERVE_SESSIONS)} sessions x {SERVE_FRAMES} frames; session 1 greedy, "
              f"its {len(tokens)} token frames equal a ServerState's on the in-memory "
              f"weights ({len(pieces)} text pieces); sessions 2 and 3 (text_seed 5) "
              f"identical, 2 and 4 not; a client queued during session 1 got "
              f"{out['queued']['queue_messages']} MT 4 queue positions, then its session")
        phase("serve", f"launches {used(launches)} = per captured step {used(expected)} x (1 "
              f"greedy capture + 2 override sets x (2 warm-up steps + 1 capture)); the first "
              f"capture alone {used(checks['first_capture'])}")
        phase("serve", f"frame sent -> PCM reply over the socket: p50 {p50:.2f} ms, p90 "
              f"{p90:.2f} ms ({len(out['ms'])} frames, captures included); [slice] p50 "
              f"{slice_p50:.2f} ms/frame in this run ({card})")
        return {"launches": launches, "per_capture": expected, "bytes": nbytes,
                "write_s": write_s, "load_s": load_s, "load_gb_s": nbytes / 1e9 / load_s,
                "p50_ms": p50, "p90_ms": p90, "slice_p50_ms": slice_p50,
                "frames": len(out["ms"]), "transport": f"aiohttp {aiohttp.__version__}",
                "queued": out["queued"], "greedy_tokens": tokens}
    except BaseException:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
        raise


# ---------------------------------------------------------------- batched
# the isolation script's copies of slot 0: slot -> (its session index,
# frames it executes in that session)
SAME_AS_0 = {1: (0, FRAMES), 2: (0, FRAMES - 5), 3: (0, FRAMES - 5), 4: (1, FRAMES - 20)}


def isolation_script(frame_size: int, slots: int = SLOTS):
    """The greedy run's schedule and PCM: (schedule, frames, the slots whose
    session must equal slot 0's)."""
    # unit-RMS noise: the random-weight Mimi maps quiet noise to one code
    # whatever the PCM, and then every slot's stream would be the same
    rs = np.random.RandomState(SEED)
    ref = rs.randn(FRAMES + 1, frame_size).astype(np.float32)
    frames = {s: rs.randn(FRAMES + 1, frame_size).astype(np.float32) for s in range(slots)}
    frames[1] = frames[2] = frames[3] = ref
    frames[0] = ref
    frames[4] = np.concatenate([frames[4][:20], ref])
    schedule = [dict.fromkeys(range(slots), "join")]
    del schedule[0][2]
    for tick in range(1, FRAMES + 1):
        t = dict.fromkeys(range(slots), "send")
        if tick < 5:
            del t[2]               # slot 2 joins 5 frames late
        elif tick == 5:
            t[2] = "join"
        if 10 <= tick <= 14:
            del t[3]               # slot 3 frozen on frames 10-14
        if tick == 20:
            t[4] = "join"          # slot 4: reset, then slot 0's PCM again
        schedule.append(t)
    return schedule, frames, SAME_AS_0


def profile_frames(run_frame, n: int) -> dict:
    """torch.profiler over n frames, run_frame(i) running frame i and
    reading its result back: the card's busy ms per frame (sum of its
    kernels' times), the host ms per frame under the profiler, and kernel ms
    per frame by name for the port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run_frame(i)
        wall = (time.perf_counter() - t0) * 1e3 / n
    busy, by_kernel, device_ops, kernels = 0.0, {}, {}, 0
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue  # host ops; their kernels are counted as device events
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        busy += us
        kernels += evt.count
        device_ops[evt.key[:80]] = us / 1e3 / n
        for name in TPU_KERNELS:
            if name in evt.key and "reduce" not in evt.key:
                by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3 / n
    top = dict(sorted(device_ops.items(), key=lambda kv: -kv[1])[:8])
    return {"host_ms_per_frame": wall, "busy_ms_per_frame": busy / 1e3 / n,
            "kernel_ms_per_frame": by_kernel, "device_ops_per_frame": kernels / n,
            "top_device_ms_per_frame": top}


def profile_line(prof: dict) -> str:
    return (f"card busy {prof['busy_ms_per_frame']:.2f} ms/frame, idle share "
            f"{prof['idle_share']:.3f} (host {prof['host_ms_per_frame']:.2f} ms/frame under the "
            f"profiler); kernels ms/frame {json.dumps(prof['kernel_ms_per_frame'])}; "
            f"{prof['device_ops_per_frame']:.0f} device ops/frame, the most costly "
            f"{json.dumps(prof['top_device_ms_per_frame'])}")


def tensor_leaves(tree) -> list:
    """Every tensor of a tree of dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def state_leaves(state) -> list:
    """Every tensor of a batched engine's streaming state (Mimi encode and
    decode, LMGen), in a fixed order."""
    return tensor_leaves([state.enc_state, state.dec_state, state.gen_state])


def every_slot_frame(state, seed: int, frames: int):
    """run_frame(i): frame i of `frames` frames of every slot sending seeded
    PCM, its outputs read back."""
    pcm = (0.1 * np.random.RandomState(seed).randn(frames, SLOTS, 1, state.frame_size)
           ).astype(np.float32)

    def run_frame(i):
        out, audio = state.frame(pcm[i], np.ones(SLOTS, bool))
        out.cpu(), audio.cpu()
    return run_frame


def host_ms(run_frame, n: int) -> list:
    """Host ms of run_frame(i) for i < n, each ending in a read back."""
    ms = []
    for i in range(n):
        t0 = time.perf_counter()
        run_frame(i)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def greedy_isolation(dev, lm, lm_params, mimi, mimi_params, what: str,
                     profile: bool = False) -> tuple[dict, dict]:
    """The greedy run of BatchedMoshiState at B = SLOTS over the isolation
    script, graphed (the main path: token checks, launch counts from the
    captured frame, one replay per frame), then eagerly (a launch count per
    frame), and the two held equal: tokens and PCM of every session, and
    every state byte at the end.  With `profile`, then 5 frames of every
    slot timed on each engine and 5 graphed ones under the profiler (card
    busy ms, kernel ms per frame, idle share of the graphed p50).  Returns
    the graphed launches and a summary."""
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState, serve_batched

    cfg = lm.config
    expected = per_step_launches(cfg, lm_params, SLOTS)
    schedule, frames, same_as_0 = isolation_script(mimi.frame_size)
    runs = {}
    for graphed in (True, False):
        state = BatchedMoshiState(mimi, mimi_params, lm, lm_params, SLOTS, device=dev,
                                  graphed=graphed, use_sampling=False)
        if graphed:
            kshape = tuple(state.gen_state["transformer"]["k"].shape)
            phase("batched", f"{what}: B = {SLOTS}, {cfg.kv_cache_dtype} KV cache {kshape} "
                  f"int8 x 2 + bf16 scales; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
                  f"on the card")
        state.warmup()
        zero_counts()
        sessions, ms = serve_batched(state, schedule, frames)
        launches = read_counts()
        kind = "graphed" if graphed else "eager"
        check_counts(launches, expected, 1 if graphed else len(ms), f"batched {what} {kind} run")
        runs[kind] = (state, sessions, ms, launches)
    state, sessions, ms, launches = runs["graphed"]
    if state.step.replays != len(ms):
        raise RuntimeError(f"{what}: {state.step.replays} replays for {len(ms)} frames")
    ref = sessions[0][0][0]
    if len(ms) != FRAMES or len(ref) != FRAMES - cfg.max_delay:
        raise RuntimeError(f"{what}: {len(ms)} frames, slot 0 generated {len(ref)}")
    for s in range(SLOTS):
        for tokens, audio in sessions[s]:
            check_tokens(tokens, cfg, f"{what} slot {s}")
            check_pcm(audio, mimi.frame_size, f"{what} slot {s}")
    for s, (session, executed) in same_as_0.items():
        got = sessions[s][session][0]
        if len(got) != executed - cfg.max_delay or not np.array_equal(got, ref[:len(got)]):
            raise RuntimeError(f"{what}: slot {s} session {session} does not repeat "
                               f"slot 0's tokens")
    distinct = sum(not np.array_equal(sessions[s][0][0], ref) for s in range(5, SLOTS))
    if distinct == 0:
        raise RuntimeError(f"{what}: no slot with its own PCM differs from slot 0")
    eager, eager_sessions, eager_ms, eager_launches = runs["eager"]
    same_tokens = all(np.array_equal(a[0], b[0]) and all(np.array_equal(x, y)
                                                         for x, y in zip(a[1], b[1]))
                      for s in range(SLOTS)
                      for a, b in zip(sessions[s], eager_sessions[s]))
    same_state = all(torch.equal(a, b) for a, b in zip(state_leaves(state), state_leaves(eager)))
    p50, p90 = (float(np.percentile(ms, p)) for p in (50, 90))
    e50, e90 = (float(np.percentile(eager_ms, p)) for p in (50, 90))
    phase("batched", f"{what}, {len(ms)} frames graphed: slots 1 (same PCM), 2 (joined 5 "
          f"frames late), 3 (frozen on frames 10-14) and 4 (reset at frame 20) repeat slot 0's "
          f"tokens; {distinct} of {SLOTS - 5} other slots differ; launches {launches} = per "
          f"frame {expected} x 1 captured frame, {state.step.replays} replays; p50 {p50:.2f} "
          f"ms, p90 {p90:.2f} ms per batched frame (eager: p50 {e50:.2f}, p90 {e90:.2f}; "
          f"launches {eager_launches}); graphed against eager: tokens and PCM "
          f"{'equal' if same_tokens else 'DIFFER'}, every state byte "
          f"{'equal' if same_state else 'DIFFERS'}")
    if not (same_tokens and same_state):
        raise RuntimeError(f"{what}: the graphed frames differ from the eager ones")
    summary = {"p50_ms": p50, "p90_ms": p90, "replays": state.step.replays,
               "eager": {"p50_ms": e50, "p90_ms": e90, "launches": eager_launches}}
    if profile:
        eager_all = host_ms(every_slot_frame(eager, SEED + 5, 5), 5)
        graphed_all = host_ms(every_slot_frame(state, SEED + 5, 5), 5)
        prof = profile_frames(every_slot_frame(state, SEED + 7, 5), 5)
        prof["p50_ms"] = float(np.percentile(graphed_all, 50))
        prof["p90_ms"] = float(np.percentile(graphed_all, 90))
        prof["eager_p50_ms"] = float(np.percentile(eager_all, 50))
        prof["eager_p90_ms"] = float(np.percentile(eager_all, 90))
        prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / prof["p50_ms"]
        phase("batched", f"{what}, every slot, 5 frames: graphed p50 {prof['p50_ms']:.2f} ms, "
              f"p90 {prof['p90_ms']:.2f} ms per batched frame (eager p50 "
              f"{prof['eager_p50_ms']:.2f}, p90 {prof['eager_p90_ms']:.2f}); profiler over 5 "
              f"graphed frames: {profile_line(prof)}")
        summary["profile"] = prof
    del runs, state, sessions, eager, eager_sessions
    free_memory()
    return launches, summary


def run_batched(dev, card: str, lm_params, mimi, mimi_params) -> dict:
    """The batched path at B = SLOTS with the int4 KV cache (its greedy run,
    then a sampled run of every slot, graphed, then a shorter eager one),
    then its greedy run with the int8 KV cache."""
    from dataclasses import replace

    from moshi_tpu_torch.models.lm import LMModel, lm_config_v0_1
    from moshi_tpu_torch.serve.batched_moshi import BatchedMoshiState, serve_batched

    cfg = replace(lm_config_v0_1(), kv_cache_dtype="int4")
    lm = LMModel(cfg)
    expected = per_step_launches(cfg, lm_params, SLOTS)
    if expected["q4_gemv"] or expected["int8_gemv"]:
        raise RuntimeError(f"the B = {SLOTS} frame would run a CUDA-core GEMV kernel: {expected}")

    # 1. greedy isolation run, graphed and eager
    greedy_launches, greedy = greedy_isolation(dev, lm, lm_params, mimi, mimi_params, "greedy")

    # 2. sampled run, every slot active: graphed (the main path), then eager
    rs = np.random.RandomState(SEED + 2)
    frames = {s: (0.1 * rs.randn(FRAMES + 1, mimi.frame_size)).astype(np.float32)
              for s in range(SLOTS)}
    runs = {}
    for graphed, n in ((True, FRAMES), (False, EAGER_FRAMES)):
        state = BatchedMoshiState(mimi, mimi_params, lm, lm_params, SLOTS, device=dev,
                                  rng_seed=SEED, graphed=graphed, use_sampling=True)
        state.warmup()
        schedule = [dict.fromkeys(range(SLOTS), "join")] + [dict.fromkeys(range(SLOTS), "send")] * n
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        sessions, ms = serve_batched(state, schedule, frames)
        launches = read_counts()
        kind = "graphed" if graphed else "eager"
        check_counts(launches, expected, 1 if graphed else len(ms), f"batched sampled {kind} run")
        for s in range(SLOTS):
            tokens, audio = sessions[s][0]
            if len(tokens) != n - cfg.max_delay:
                raise RuntimeError(f"sampled {kind} slot {s}: {len(tokens)} frames generated")
            check_tokens(tokens, cfg, f"sampled {kind} slot {s}")
            check_pcm(audio, mimi.frame_size, f"sampled {kind} slot {s}")
        runs[kind] = {"launches": launches, "frames": len(ms),
                      **{f"p{p}_ms": float(np.percentile(ms, p)) for p in (50, 75, 90)},
                      "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                      "reserved_gib": torch.cuda.memory_reserved(dev) / 2 ** 30}
        if graphed:
            if state.step.replays != len(ms):
                raise RuntimeError(f"sampled: {state.step.replays} replays for {len(ms)} frames")
            runs[kind]["replays"] = state.step.replays
            # the profiler slows the host, so the idle share is taken against
            # the frame time measured without it
            prof = profile_frames(every_slot_frame(state, SEED + 1, 5), 5)
            prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / runs[kind]["p50_ms"]
            runs[kind]["profile"] = prof
        del state, sessions
        free_memory()
    g, e = runs["graphed"], runs["eager"]
    phase("batched", f"sampled, {g['frames']} frames x {SLOTS} slots graphed: p50 "
          f"{g['p50_ms']:.2f} ms, p75 {g['p75_ms']:.2f} ms, p90 {g['p90_ms']:.2f} ms per batched "
          f"frame; {g['p50_ms'] / SLOTS:.2f} ms per user-frame at p50; peak {g['peak_gib']:.2f} "
          f"GiB allocated, {g['reserved_gib']:.2f} GiB reserved; launches {g['launches']} = per "
          f"frame {expected} x 1 captured frame, {g['replays']} replays ({card})")
    phase("batched", f"sampled, {e['frames']} frames x {SLOTS} slots eager: p50 "
          f"{e['p50_ms']:.2f} ms, p90 {e['p90_ms']:.2f} ms per batched frame; peak "
          f"{e['peak_gib']:.2f} GiB allocated, {e['reserved_gib']:.2f} GiB reserved; launches "
          f"{e['launches']} ({card})")
    phase("batched", f"profiler over 5 graphed sampled frames: {profile_line(g['profile'])}")

    # 3. the greedy run with the int8 KV cache (the worker's kv_cache = "int8")
    lm8 = LMModel(replace(cfg, kv_cache_dtype="int8"))
    int8_launches, int8 = greedy_isolation(dev, lm8, lm_params, mimi, mimi_params,
                                           "int8 greedy", profile=True)
    return {"launches": {"greedy": greedy_launches, "sampled": g["launches"],
                         "int8_greedy": int8_launches},
            "per_frame": {"int4": expected,
                          "int8": per_step_launches(lm8.config, lm_params, SLOTS)},
            "sampled": g, "sampled_eager": e, "greedy": greedy, "int8_greedy": int8}


# ---------------------------------------------------------------- offline
def cast_tree(tree, dtype):
    """A copy of a param tree with every floating tensor in `dtype`."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def timed(fn, reps: int = 3):
    """(result, p50 host ms) of reps calls of fn after one warm-up call,
    each ending in a synchronize."""
    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.percentile(ms, 50))


def stream_encode(mimi, params, pcm, dtype):
    """Codes of pcm [B, 1, n * frame_size] by encode_step, one frame at a
    time from a fresh state."""
    state = mimi.init_encode_state(pcm.shape[0], dtype, pcm.device)
    fs = mimi.frame_size
    return torch.cat([mimi.encode_step(params, state, pcm[..., f * fs:(f + 1) * fs])[0]
                      for f in range(pcm.shape[-1] // fs)], dim=-1)


def stream_decode(mimi, params, codes, dtype):
    state = mimi.init_decode_state(codes.shape[0], dtype, codes.device)
    return torch.cat([mimi.decode_step(params, state, codes[..., f:f + 1])[0]
                      for f in range(codes.shape[-1])], dim=-1)


def offline_mimi(dev, card: str, mimi, params, dtype, phase_name: str = "offline",
                 what: str = "Mimi v0.1") -> dict:
    """Mimi's offline encode and decode in `dtype` against encode_step /
    decode_step over the same input from a fresh state: the share of equal
    codes (with the first difference's frame and codebook) and the relative
    error of the decoded PCM, each held to OFFLINE_BOUNDS; the offline
    calls' ms and seconds of audio per second.  Printed under `phase_name`,
    the codec named `what`."""
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    B, n, extra = OFFLINE_MIMI["batch"], OFFLINE_MIMI["frames"], OFFLINE_MIMI["extra"]
    fs = mimi.frame_size
    rs = np.random.RandomState(SEED + 20)
    pcm = torch.from_numpy((0.1 * rs.randn(B, 1, n * fs)).astype(np.float32)).to(dev, dtype)
    longer = torch.from_numpy((0.1 * rs.randn(1, 1, n * fs + extra)).astype(np.float32)).to(
        dev, dtype)
    codes, enc_ms = timed(lambda: mimi.encode(params, pcm))
    codes_long = mimi.encode(params, longer)
    n_long = -(-longer.shape[-1] // fs)
    if codes.shape != (B, mimi.num_codebooks, n) or codes_long.shape[-1] != n_long:
        raise RuntimeError(f"offline {name}: codes {tuple(codes.shape)}, "
                           f"{tuple(codes_long.shape)}")
    ref = stream_encode(mimi, params, pcm, dtype)
    ref_long = stream_encode(mimi, params, torch.nn.functional.pad(
        longer, (0, n_long * fs - longer.shape[-1])), dtype)
    equal = torch.cat([(codes == ref).flatten(), (codes_long == ref_long).flatten()])
    share = equal.float().mean().item()
    first = None
    if share < 1.0:
        diff = (codes != ref).nonzero()
        diff = diff if len(diff) else (codes_long != ref_long).nonzero()
        b, k, f = diff[diff[:, 2].argmin()].tolist()
        first = {"slot": b, "codebook": k, "frame": f}
    pcm_off, dec_ms = timed(lambda: mimi.decode(params, codes))
    pcm_ref = stream_decode(mimi, params, codes, dtype)
    if pcm_off.shape != pcm_ref.shape or not bool(torch.isfinite(pcm_off).all()):
        raise RuntimeError(f"offline {name}: decode gave {tuple(pcm_off.shape)} or non-finite PCM")
    err = rel_err(pcm_off, pcm_ref)
    bounds = OFFLINE_BOUNDS[name]
    seconds = B * n * fs / mimi.config.sample_rate
    ok = share >= bounds["share"] and err <= bounds["pcm"]
    phase(phase_name, f"{what} {name}, B = {B} x {n} frames ({seconds / B:.1f} s each) and "
          f"one input {extra} samples longer: encode {enc_ms:.2f} ms "
          f"({seconds / enc_ms * 1e3:.1f} s of audio per s), decode {dec_ms:.2f} ms "
          f"({seconds / dec_ms * 1e3:.1f} s/s); codes equal to encode_step's: share "
          f"{share:.6f} (bound >= {bounds['share']}; first difference {first}); decode against "
          f"decode_step: rel err {err:.3e} (bound {bounds['pcm']:.0e}) "
          f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise RuntimeError(f"offline {what} {name} disagrees with its streaming path")
    return {"encode_ms": enc_ms, "decode_ms": dec_ms, "audio_s": seconds,
            "encode_audio_s_per_s": seconds / enc_ms * 1e3,
            "decode_audio_s_per_s": seconds / dec_ms * 1e3, "codes_equal_share": share,
            "first_difference": first, "pcm_rel_err": err}


class RowsSeen:
    """Records the rows of x of every q4_wgmma launch while it is entered
    (the wrapper's counter counts launches only): the wrapper plans each
    launch with one call of q4matmul.wgmma_plan_splits, whose last argument
    is M."""

    def __enter__(self):
        from moshi_tpu_torch.ops import q4matmul

        self.rows, self._orig = [], q4matmul.wgmma_plan_splits

        def spy(din, dout, group_size, num_sms, rows):
            self.rows.append(rows)
            return self._orig(din, dout, group_size, num_sms, rows)
        q4matmul.wgmma_plan_splits = spy
        return self

    def __exit__(self, *exc):
        from moshi_tpu_torch.ops import q4matmul

        q4matmul.wgmma_plan_splits = self._orig


def offline_lm(dev, card: str, lm, lm_params) -> dict:
    """Moshi-7B's teacher-forced forward (LMModel.forward, q4 temporal
    linears and text head, int8 depformer, bf16) over seeded codes
    [OFFLINE_LM batch, 17, frames]: exact launches (one q4_wgmma of B * T rows
    per q4 linear, no other GEMV), finite logits where the masks say and
    masks equal to the plain ones on the CPU; forward_text's text logits
    against forward_text_step over the bf16 ring KV cache one frame at a
    time; p50 of 5 calls and a profiler pass."""
    from moshi_tpu_torch.models.lm import undelay_logits

    cfg = lm.config
    B, T = OFFLINE_LM["batch"], OFFLINE_LM["frames"]
    rs = np.random.RandomState(SEED + 21)
    codes = rs.randint(0, cfg.card, (B, cfg.num_codebooks, T))
    codes[:, 0] = rs.randint(0, cfg.text_card, (B, T))
    codes = torch.from_numpy(codes).to(dev)
    expected = dict.fromkeys(counters(), 0)
    expected["q4_wgmma"] = sum(Q4_SHAPES.values())

    zero_counts()
    with RowsSeen() as seen:
        out = lm.forward(lm_params, codes)
    launches = read_counts()
    if launches != expected or seen.rows != [B * T] * expected["q4_wgmma"]:
        raise RuntimeError(f"offline forward: launches {launches} (expected {expected}), "
                           f"q4_wgmma rows {sorted(set(seen.rows))}")
    audio = slice(cfg.audio_offset, cfg.audio_offset + cfg.dep_q)
    cpu = codes.cpu()
    _, mask = undelay_logits(cfg.delays[audio], torch.zeros(B, cfg.dep_q, T, 1))
    _, text_mask = undelay_logits(cfg.delays[:1], torch.zeros(B, 1, T, 1))
    mask &= cpu[:, audio] != -1
    text_mask &= cpu[:, :1] != -1
    if not (torch.equal(out["mask"].cpu(), mask) and torch.equal(out["text_mask"].cpu(), text_mask)):
        raise RuntimeError("offline forward: masks differ from the plain ones")
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if (shapes["logits"] != (B, cfg.dep_q, T, cfg.card)
            or shapes["text_logits"] != (B, 1, T, cfg.text_out_card)
            or not bool(torch.isfinite(out["logits"][out["mask"]]).all())
            or not bool(torch.isfinite(out["text_logits"][out["text_mask"]]).all())
            or not bool(torch.isnan(out["logits"][~out["mask"]]).all())):
        raise RuntimeError(f"offline forward: outputs {shapes} not finite where the masks say")
    del out
    _, fwd_ms = timed(lambda: lm.forward(lm_params, codes), reps=5)
    prof = profile_frames(lambda i: (lm.forward(lm_params, codes), torch.cuda.synchronize()), 1)
    q4_ms = prof["kernel_ms_per_frame"].get("q4_wgmma", 0.0)

    # streaming == offline: the text logits of forward_text against T single
    # steps of forward_text_step over the bf16 ring KV cache
    _, text_off = lm.forward_text(lm_params, codes)
    state = lm.transformer.init_state(B, torch.bfloat16, dev)
    text_step = torch.cat([lm.forward_text_step(lm_params, state, codes[:, :, t:t + 1])[1]
                           for t in range(T)], dim=2)
    diff = text_off.float() - text_step.float()
    err = (diff.norm() / text_step.float().norm()).item()
    err_max = rel_err(text_off, text_step)
    argmax = (text_off.argmax(-1) == text_step.argmax(-1)).float().mean().item()
    bound_ = OFFLINE_BOUNDS["lm_text_logits"]
    ok = err <= bound_ and bool(torch.isfinite(text_off).all())
    phase("offline", f"Moshi-7B q4 LMModel.forward over codes [{B}, {cfg.num_codebooks}, {T}]: "
          f"launches {launches} (every q4_wgmma of {B * T} rows); masks equal the plain ones; "
          f"p50 {fwd_ms:.2f} ms of 5, {B * T / fwd_ms * 1e3:.0f} scored frames/s; profiler: "
          f"card busy {prof['busy_ms_per_frame']:.2f} ms, q4_wgmma {q4_ms:.2f} ms of it "
          f"({q4_ms / prof['busy_ms_per_frame']:.3f}); top {json.dumps(prof['top_device_ms_per_frame'])} "
          f"({card})")
    phase("offline", f"forward_text against {T} forward_text_step over the bf16 ring KV: text "
          f"logits ||diff|| / ||step|| {err:.3e} (bound {bound_:.0e}), max |diff| / max |step| "
          f"{err_max:.3e}, greedy argmax agreement {argmax:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("offline text logits disagree with the streaming ones")
    del state
    free_memory()
    return {"launches": launches, "q4_wgmma_rows": B * T, "p50_ms": fwd_ms,
            "scored_frames_per_s": B * T / fwd_ms * 1e3, "profile": prof,
            "q4_wgmma_busy_share": q4_ms / prof["busy_ms_per_frame"],
            "text_logits_rel_err": err, "text_logits_max_rel_err": err_max,
            "text_argmax_agreement": argmax}


def run_offline(dev, card: str, lm, lm_params, mimi, mimi_params) -> dict:
    """The offline halves at full width: Mimi v0.1's encode / decode in f32
    (the bf16 weights cast up) and in bf16, then Moshi-7B's forward."""
    mimi32 = cast_tree(mimi_params, torch.float32)
    res = {"mimi_f32": offline_mimi(dev, card, mimi, mimi32, torch.float32)}
    del mimi32
    free_memory()
    res["mimi_bf16"] = offline_mimi(dev, card, mimi, mimi_params, torch.bfloat16)
    res.update(offline_lm(dev, card, lm, lm_params))
    return res


# ---------------------------------------------------------------- configs
def configs_prefill(dev, card: str, lm, lm_params) -> dict:
    """(a) A prefill over each KV cache at Moshi-7B's full width ([slice]'s
    q4 weights, the temporal transformer and text head): B =
    CONFIGS_BATCH, context 3000, caches model dtype, int8, int4 in turn.
    Run 1: CONFIGS_STEPS steps of T = 1, one step of T = CONFIGS_CHUNK,
    CONFIGS_STEPS steps of T = 1; run 2: as many steps of T = 1 on the same
    seeded codes.  The text logits of the last CONFIGS_STEPS steps, chunked
    against per-step (norm-relative), held to HIBIKI_WITNESS_BOUND over the
    model-dtype and int8 caches; over int4, where a T = 1 step merges its
    own row unquantized and a chunk reads its rows back at 4 bits, to the
    per-step int4 run's own distance from the model-dtype one (the cache's
    quantization error; tests/test_torch_configs.py holds the same), each
    printed beside the bound; the chunk's launches exactly one q4_wgmma of
    B * T rows per q4 linear and nothing else; its host ms and peak GiB."""
    from dataclasses import replace

    from moshi_tpu_torch.models.lm import LMModel

    B, n, T = CONFIGS_BATCH, CONFIGS_STEPS, CONFIGS_CHUNK
    total = 2 * n + T
    rs = np.random.RandomState(SEED + 40)
    codes = rs.randint(0, lm.config.card, (B, lm.config.num_codebooks, total))
    codes[:, 0] = rs.randint(0, lm.config.text_card, (B, total))
    codes = torch.from_numpy(codes).to(dev)
    chunk_expected = dict.fromkeys(counters(), 0)
    chunk_expected["q4_wgmma"] = sum(Q4_SHAPES.values())
    out, exact = {}, None
    for kv in ("model", "int8", "int4"):
        m = LMModel(replace(lm.config, kv_cache_dtype=kv))

        def step(state, a, b):
            return m.forward_text_step(lm_params, state, codes[:, :, a:b])[1]

        zero_counts()
        state = m.transformer.init_state(B, torch.bfloat16, dev)
        for t in range(n):
            step(state, t, t + 1)
        before = read_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with RowsSeen() as seen:
            step(state, n, n + T)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        chunk = {k: v - before[k] for k, v in read_counts().items()}
        chunked = torch.cat([step(state, t, t + 1) for t in range(n + T, total)], dim=2)
        del state
        state = m.transformer.init_state(B, torch.bfloat16, dev)
        per = torch.cat([step(state, t, t + 1) for t in range(total)][-n:], dim=2)
        launches = read_counts()
        del state
        def rel(a, b):
            return ((a.float() - b.float()).norm() / b.float().norm()).item()

        exact = per if kv == "model" else exact
        err, own = rel(chunked, per), rel(per, exact)
        limit = own if kv == "int4" else HIBIKI_WITNESS_BOUND
        ok = (err <= limit and chunk == chunk_expected
              and seen.rows == [B * T] * chunk_expected["q4_wgmma"]
              and bool(torch.isfinite(chunked).all()) and bool(torch.isfinite(per).all()))
        phase("configs", f"(a) prefill over the {kv} KV cache, Moshi-7B q4, B = {B}, ctx "
              f"{m.config.context}: {n} steps, a chunk of {T}, {n} steps against {total} "
              f"single steps: text logits of the last {n} ||diff|| / ||per-step|| {err:.3e} "
              f"({'under' if err <= HIBIKI_WITNESS_BOUND else 'above'} "
              f"{HIBIKI_WITNESS_BOUND:.0e}; held to {limit:.3e}), the per-step run against the "
              f"model-dtype cache's {own:.3e}; the chunk: "
              f"launches {used(chunk)}, q4_wgmma rows {sorted(set(seen.rows))}, host "
              f"{chunk_ms:.2f} ms, peak {peak:.2f} GiB; both runs' launches {used(launches)} "
              f"{'ok' if ok else 'FAIL'} ({card})")
        if not ok:
            raise RuntimeError(f"configs (a): the {kv} cache's prefill fails its checks")
        out[kv] = {"text_logits_rel_err": err, "per_step_vs_model_dtype": own,
                   "held_to": limit, "chunk_launches": chunk, "chunk_host_ms": chunk_ms,
                   "chunk_peak_gib": peak, "launches": launches}
        free_memory()
    return out


def configs_tts_run(dev, models, lm, tts, cp_params, slots: int, what: str) -> dict:
    """One engine of CONFIGS_TTS_ROWS model rows (`slots` slots of `tts`,
    int8 weights, int4 KV), graphed then eager, each slot opened with a
    seeded voice and fed words: the eager frames and the graphed ones equal
    in tokens and PCM, and every state byte after CONFIGS_TTS_EAGER frames;
    the graphed run's launches one capture of each graph, the eager run's
    each frame's: every int8 linear one int8_wgmma launch, the heads of
    32001 and 2049 columns two 16-row int8_gemv launches.  Returns
    the graphed launches, the per-frame counts, the replay frames' p50 /
    p90 and the first frame's ms."""
    from moshi_tpu_torch.serve.batched_tts import BatchedTTSState

    per = tts_launches(lm.config, models["lm_params"], CONFIGS_TTS_ROWS)
    per_frame = {k: per["main"][k] + per["depth"][k] for k in per["main"]}
    if per_frame["int8_mma"] or not per_frame["int8_wgmma"]:
        raise RuntimeError(f"configs (b) {what}: a frame would launch {used(per_frame)}")
    runs = {}
    for graphed, frames in ((True, CONFIGS_TTS_FRAMES), (False, CONFIGS_TTS_EAGER)):
        state = BatchedTTSState(tts, models["lm_params"], models["mimi_params"], slots,
                                condition_params=cp_params, voice_frames=TTS_VOICE[0],
                                device=dev, graphed=graphed, rng_seed=SEED)
        if state.h.shape[0] != CONFIGS_TTS_ROWS:
            raise RuntimeError(f"configs (b) {what}: {state.h.shape[0]} model rows")
        state.warmup()
        rs = np.random.RandomState(SEED + 41)
        for s in range(slots):
            state.open_slot(s)
            state.set_slot_voice(s, rs.randn(*TTS_VOICE).astype(np.float32))
        state.apply_pending_ops()
        zero_counts()
        outs, ms, leaves = [], [], None
        for i in range(frames):
            for s in range(slots):
                if len(state.slots[s].state.entries) < 4:
                    state.feed_words(s, tts_words(6, s))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = state.tick()
            ms.append((time.perf_counter() - t0) * 1e3)
            if res is None:
                raise RuntimeError(f"configs (b) {what}: no slot ran")
            outs.append((res[1].copy(), res[2].copy(),
                         [list(state.slots[s].outbox) for s in range(slots)]))
            for s in range(slots):
                state.slots[s].outbox.clear()
            if i == CONFIGS_TTS_EAGER - 1:
                leaves = [t.clone() for t in tts_leaves(state)]
        runs[graphed] = {"launches": read_counts(), "outs": outs, "ms": ms, "leaves": leaves,
                         "replays": (state.main[True].replays, state.depth.replays)}
        del state
        free_memory()
    g, e = runs[True], runs[False]
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1].view(np.uint8),
                                                              b[1].view(np.uint8))
               and [[x[0] for x in o] for o in a[2]] == [[x[0] for x in o] for o in b[2]]
               for a, b in zip(g["outs"], e["outs"]))
    same_state = all(same_bytes(a, b) for a, b in zip(g["leaves"], e["leaves"]))
    check_counts(g["launches"], per_frame, 1, f"configs (b) {what} graphed run")
    check_counts(e["launches"], per_frame, CONFIGS_TTS_EAGER, f"configs (b) {what} eager run")
    if g["replays"] != (CONFIGS_TTS_FRAMES, CONFIGS_TTS_FRAMES):
        raise RuntimeError(f"configs (b) {what}: replays {g['replays']}")
    delivered = [x[1] for _, _, boxes in g["outs"] for box in boxes for x in box
                 if x[0] == "pcm"]
    for tokens, _, _ in g["outs"]:
        check_tts_frames(tokens[:, :, 0], lm.config, f"configs (b) {what}")
    check_pcm(delivered, models["mimi"].frame_size, f"configs (b) {what}")
    replays = g["ms"][1:]
    p50, p90 = (float(np.percentile(replays, p)) for p in (50, 90))
    phase("configs", f"(b) {what}: {CONFIGS_TTS_FRAMES} greedy frames graphed, "
          f"{CONFIGS_TTS_EAGER} eager: tokens and PCM {'equal' if same else 'DIFFER'}, every "
          f"state byte after {CONFIGS_TTS_EAGER} frames {'equal' if same_state else 'DIFFERS'} "
          f"({len(delivered)} PCM frames delivered: the audio runs {tts.delay_steps} frames "
          f"behind the text); "
          f"per frame {used(per_frame)} (eager run {used(e['launches'])}, graphed run "
          f"{used(g['launches'])}: one capture of each graph); replays {g['replays']}; "
          f"frames 2-{CONFIGS_TTS_FRAMES} (replays) p50 {p50:.2f} ms, p90 {p90:.2f} ms per "
          f"batched frame ({'' if p90 < 80 else 'not '}real time), {p50 / slots:.3f} ms per "
          f"stream; the first (the captures) {g['ms'][0]:.2f} ms; eager p50 "
          f"{float(np.percentile(e['ms'], 50)):.2f} ms")
    if not (same and same_state):
        raise RuntimeError(f"configs (b) {what}: graphed frames differ from eager ones")
    return {"launches": g["launches"], "eager_launches": e["launches"], "per_frame": per_frame,
            "pcm_frames_delivered": len(delivered),
            "p50_ms": p50, "p90_ms": p90, "first_ms": g["ms"][0],
            "ms_per_stream": p50 / slots, "eager_p50_ms": float(np.percentile(e["ms"], 50))}


def configs_tts(dev, card: str, models) -> dict:
    """(b) Batched TTS above 16 model rows on [tts]'s weights: B =
    CONFIGS_TTS_SLOTS slots without CFG, then B = CONFIGS_TTS_CFG_SLOTS under
    true CFG (cfg_coef CONFIGS_TTS_CFG on the model built without the `cfg`
    condition), each CONFIGS_TTS_ROWS model rows."""
    from moshi_tpu_torch.conditioners import ConditionFuser, ConditionProvider
    from moshi_tpu_torch.models.tts import StateMachine, TokenIds, TTSModel

    lm = models["lm"]
    c = lm.config
    plain = ConditionProvider({"speaker_wavs": models["provider"].conditioners["speaker_wavs"]})
    cfg_tts = TTSModel(lm, models["mimi"], TtsTokenizer(),
                       StateMachine(TokenIds(card=c.text_card + 1), max_padding=8,
                                    initial_padding=2),
                       delay_steps=TTS_DELAY_STEPS, condition_provider=plain,
                       fuser=ConditionFuser({"cross": ["speaker_wavs"]}),
                       max_speakers=TTS_MAX_SPEAKERS, temp=0.0, cfg_coef=CONFIGS_TTS_CFG,
                       n_q=c.dep_q, max_gen_length=10_000, final_padding=4)
    cp_plain = {"speaker_wavs": models["cp_params"]["speaker_wavs"]}
    out = {"no_cfg": configs_tts_run(dev, models, lm, tts_model(models, lm, 0.0),
                                     models["cp_params"], CONFIGS_TTS_SLOTS,
                                     f"B = {CONFIGS_TTS_SLOTS} slots without CFG"),
           "cfg": configs_tts_run(dev, models, lm, cfg_tts, cp_plain, CONFIGS_TTS_CFG_SLOTS,
                                  f"B = {CONFIGS_TTS_CFG_SLOTS} slots under true CFG "
                                  f"{CONFIGS_TTS_CFG}")}
    phase("configs", f"(b) tts_v0_1 int8, int4 KV at ctx {c.context}, bf16 Mimi with "
          f"{models['mimi'].num_codebooks} codebooks, {CONFIGS_TTS_ROWS} model rows both ways "
          f"({card})")
    return out


def configs_mimi(dev, card: str) -> dict:
    """(c) Mimi at v0.1's widths in f32 with every option on: replicate
    padding, SEANet shortcut convs, a gelu-gated transformer of d_model
    CONFIGS_MIMI_DIM (16 heads of 64) between the 512-wide SEANet ends, so
    both projections are real; offline against streaming over [offline]'s
    PCM, held to OFFLINE_BOUNDS["f32"]."""
    from dataclasses import replace

    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config

    base = mimi_v0_1_config(8)
    cfg = replace(base, seanet=replace(base.seanet, pad_mode="replicate", true_skip=False),
                  transformer=replace(base.transformer, d_model=CONFIGS_MIMI_DIM,
                                      num_heads=CONFIGS_MIMI_DIM // 64,
                                      dim_feedforward=4 * CONFIGS_MIMI_DIM, gating="gelu"))
    mimi = MimiModel(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 42)
    params = mimi.init_params(g, torch.float32, dev)
    et = params["encoder_transformer"]
    if not ("input_proj" in et and "weight" in et["output_projs"][0]
            and "shortcut" in params["encoder"]["model"][1]):
        raise RuntimeError("configs (c): the Mimi tree lacks its projections or shortcuts")
    res = offline_mimi(dev, card, mimi, params, torch.float32, "configs",
                       f"(c) Mimi at v0.1's widths with replicate padding, shortcut convs and "
                       f"a gelu-gated transformer of d_model {CONFIGS_MIMI_DIM} (both "
                       f"projections)")
    del params
    free_memory()
    return res


# -------------------------------------------------------------------- asr
# ----------------------------------------------------------------- hibiki
HIBIKI_DIR = ROOT / "build" / "hibiki_checkpoint"
# a Hibiki checkpoint's depformer fields on s2s_2b_16rvq_202501: 9 weight
# sets for 16 steps, rank-128 depformer embeddings
HIBIKI_SCHEDULE = (0, 1, 2, 3, 4, 5, 6, 7, 8, 8, 8, 8, 8, 8, 8, 8)
HIBIKI_LOW_RANK = 128
# the `description` LUT of Hibiki checkpoints (its width is the script's
# choice: no checkpoint on the card's machine)
HIBIKI_LUT = {"n_bins": 2, "dim": 16, "tokenizer": "noop",
              "possible_values": ["very_bad", "very_good"]}
HIBIKI_SECONDS = 3       # seeded PCM fed before the end-of-stream frame
HIBIKI_MAX_STEPS = 60
HIBIKI_CFG = 3.0         # run (b): B = 2 under CFG, 4 model rows
HIBIKI_WITNESS_STEPS = 8
# ||logits(kernels) - logits(plain)|| / ||logits(plain)|| of the text logits
# over the witness steps, at most (PERF.md §6, stated before the first run)
HIBIKI_WITNESS_BOUND = 5e-2


def write_hibiki_checkpoint(dev, out: Path) -> dict:
    """Seeded s2s_2b_16rvq_202501 at full width with HIBIKI_SCHEDULE and
    HIBIKI_LOW_RANK (q4 temporal linears and head, int8 depformer, bf16
    ring KV at ctx 3000), a bf16 Mimi with 16 codebooks and the
    `description` LUT, written as a native checkpoint: the LUT's tensors
    under their PyTorch names in the LM's file, a greedy lm_gen_config, a
    synthetic tokenizer of the text vocabulary."""
    import dataclasses
    from moshi_tpu_torch.conditioners import LUTConditioner
    from moshi_tpu_torch.models.lm import LMModel, lm_config_s2s_2b_16rvq_202501
    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config
    from moshi_tpu_torch.models.native_ckpt import flatten_tree, save_mimi_params
    from moshi_tpu_torch.text.spm import spm_model_bytes
    from moshi_tpu_torch.utils.quantize import quantize_lm_params
    from moshi_tpu_torch.utils.safetensors import save_file

    t0 = time.perf_counter()
    cfg = dataclasses.replace(lm_config_s2s_2b_16rvq_202501(),
                              depformer_weights_per_step_schedule=HIBIKI_SCHEDULE,
                              depformer_low_rank_embeddings=HIBIKI_LOW_RANK)
    lm = LMModel(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    params = quantize_lm_params(lm.init_params(g, torch.bfloat16, dev), mode="int4")
    mimi = MimiModel(mimi_v0_1_config(max(cfg.dep_q, cfg.n_q - cfg.dep_q)))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    lut = LUTConditioner(output_dim=cfg.dim, **HIBIKI_LUT).init_params(g, torch.float32, dev)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    flat = flatten_tree(params)
    prefix = "condition_provider.conditioners.description"
    flat[f"{prefix}.embed.weight"] = lut["embed"]
    flat[f"{prefix}.output_proj.weight"] = lut["output_proj"].t()
    flat[f"{prefix}.learnt_padding"] = lut["learnt_padding"]
    nbytes = save_file(flat, out / "model.native.safetensors")
    nbytes += save_mimi_params(out / "mimi.native.safetensors", mimi, mimi_params)
    (out / "tokenizer.model").write_bytes(spm_model_bytes(cfg.text_card))
    config = {k: list(v) if isinstance(v, tuple) else v
              for k, v in dataclasses.asdict(cfg).items()}
    config.update(moshi_name="model.native.safetensors", mimi_name="mimi.native.safetensors",
                  tokenizer_name="tokenizer.model", model_type="hibiki", native_format=True,
                  lm_gen_config={"use_sampling": False},
                  conditioners={"description": {"type": "lut", "lut": HIBIKI_LUT}},
                  fuser={"sum": ["description"], "cross": []})
    (out / "config.json").write_text(json.dumps(config, indent=2))
    phase("hibiki", f"s2s_2b_16rvq_202501 q4 (dim {cfg.dim}, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads x {cfg.transformer_config.head_dim}, hidden "
          f"{cfg.transformer_config.hidden}, text_card {cfg.text_card}; depformer "
          f"{cfg.dep_q} steps on {cfg.num_depformer_in} weight sets, low rank "
          f"{HIBIKI_LOW_RANK}) + Mimi bf16 with {mimi.num_codebooks} codebooks built from "
          f"seed {SEED + 5} in {built:.1f} s; written as a native checkpoint of "
          f"{nbytes / 1e9:.3f} GB in {time.perf_counter() - t0 - built:.1f} s")
    expected = {B: per_step_launches(cfg, params, B, HIBIKI_Q4_SHAPES, HIBIKI_INT8_SHAPES)
                for B in HIBIKI_ROWS}
    del params, mimi_params, lut
    free_memory()
    return {"bytes": nbytes, "expected": expected}


def hibiki_cli(dev, args: list) -> tuple:
    """run_inference.main over HIBIKI_DIR on `dev` with its launches:
    (state, outputs, launches, peak GiB)."""
    from moshi_tpu_torch import run_inference

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    state, outs = run_inference.main(["--checkpoint-dir", str(HIBIKI_DIR), "--device", str(dev),
                                      "--max-steps", str(HIBIKI_MAX_STEPS), *args])
    return state, outs, read_counts(), torch.cuda.max_memory_allocated() / 2**30


def check_hibiki_run(state, outs, launches, expected, what: str) -> dict:
    """Launches equal the reckoning per LMGen.step, the end-of-stream frame
    fed once, PCM of as many frames as text tokens and finite, tokens in
    range."""
    st, fs, text_card = state.stats, state.mimi.frame_size, state.lm.config.text_card
    check_counts(launches, expected, st["lm_steps"], what)
    if st["eos_frames"] != 1:
        raise RuntimeError(f"{what}: the end-of-stream frame was fed {st['eos_frames']} times")
    for text, pcm in outs:
        if pcm.shape != (1, len(text) * fs) or not np.isfinite(pcm).all():
            raise RuntimeError(f"{what}: PCM of shape {pcm.shape} for {len(text)} tokens")
        if not ((text >= 0) & (text < text_card)).all():
            raise RuntimeError(f"{what}: text token out of range")
    ms = np.asarray(st["step_ms"])
    return {"steps": st["steps"], "lm_steps": st["lm_steps"], "tokens": st["tokens"],
            "p50_ms": float(np.percentile(ms, 50)), "p90_ms": float(np.percentile(ms, 90)),
            "launches": {k: v for k, v in launches.items() if v}}


def hibiki_witness(state, pcm) -> dict:
    """The first HIBIKI_WITNESS_STEPS temporal steps of run (a) with the
    kernels, their inputs recorded, then the same inputs through the plain
    GEMVs in the kernels' place: the text logits' relative error (norm and
    max) and how many steps agree on the greedy text token."""
    lm, calls = state.lm, []
    kernel_step = lm.forward_text_step

    def recorded(params, tr_state, seq, sum_condition=None, exec_mask=None):
        h, logits, tr_state = kernel_step(params, tr_state, seq, sum_condition=sum_condition,
                                          exec_mask=exec_mask)
        calls.append((seq.clone(), exec_mask.clone(), logits.float().clone()))
        return h, logits, tr_state

    lm.forward_text_step = recorded
    try:
        state.run(pcm, max_steps=HIBIKI_WITNESS_STEPS)
    finally:
        del lm.forward_text_step
    zero_counts()
    with plain_gemvs():
        tr = lm.transformer.init_state(calls[0][0].shape[0], torch.bfloat16, state.device)
        got, want = [], []
        for seq, mask, logits in calls[:HIBIKI_WITNESS_STEPS]:
            _, ref, tr = lm.forward_text_step(state.lm_params, tr, seq,
                                              sum_condition=state.condition_sum,
                                              exec_mask=mask)
            got.append(logits)
            want.append(ref.float())
    if any(read_counts().values()):
        raise RuntimeError("hibiki: the plain witness launched kernels")
    got, want = torch.stack(got), torch.stack(want)
    norm_err = ((got - want).norm() / want.norm()).item()
    same = (got.argmax(-1) == want.argmax(-1)).all(-1).flatten()
    return {"steps": len(got), "norm_rel_err": norm_err, "max_rel_err": rel_err(got, want),
            "same_argmax_steps": int(same.sum())}


def run_hibiki(dev, card: str) -> dict:
    """Hibiki-2B through run_inference's CLI (the `main` a user calls), over
    a checkpoint written first: run (a) B = 1 twice (equal tokens), run (b)
    B = 2 under CFG, each HIBIKI_SECONDS of seeded PCM, the end-of-stream
    frame, then silence, greedy, to HIBIKI_MAX_STEPS; after the first run,
    the plain witness of its first steps.  The checkpoint is deleted."""
    from moshi_tpu_torch import audio

    try:
        written = write_hibiki_checkpoint(dev, HIBIKI_DIR)
        expected = written["expected"]
        wav = HIBIKI_DIR / "in.wav"
        pcm = (0.3 * np.random.RandomState(SEED + 6).randn(HIBIKI_SECONDS * 24000)
               ).astype(np.float32)
        audio.write_wav(wav, pcm, 24000)
        runs, texts, peak = {}, [], 0.0
        for name, B, cfg_coef in (("b1", 1, 1.0), ("b1_again", 1, 1.0),
                                  ("cfg_b2", 2, HIBIKI_CFG)):
            t0 = time.perf_counter()
            state, outs, launches, gib = hibiki_cli(
                dev, ["--batch-size", str(B), "--cfg-coef", str(cfg_coef), str(wav),
                 str(HIBIKI_DIR / f"out_{name}.wav")])
            wall = time.perf_counter() - t0
            rows = B * (2 if cfg_coef != 1.0 else 1)
            runs[name] = check_hibiki_run(state, outs, launches, expected[rows],
                                          f"hibiki {name}")
            runs[name].update(wall_s=wall, peak_gib=gib, batch=B, cfg_coef=cfg_coef)
            peak = max(peak, gib)
            texts.append(outs[0][0])
            w = state.lm_params["text_emb"]["weight"]
            if not torch.equal(w[2], w[3]):
                raise RuntimeError("hibiki: text_emb row 2 (EOS) is not row 3 (PAD)")
            r = runs[name]
            phase("hibiki", f"run_inference.main --batch-size {B} --cfg-coef {cfg_coef}: "
                  f"{r['steps']} steps ({r['lm_steps']} LMGen.step, the end-of-stream frame "
                  f"once), {r['tokens']} frames of text and PCM; ms/step p50 "
                  f"{r['p50_ms']:.2f}, p90 {r['p90_ms']:.2f}; launches {r['launches']} "
                  f"= {expected[rows]} x {r['lm_steps']}; peak {gib:.2f} GiB; {wall:.1f} s "
                  f"with the load ({card})")
            if name == "b1":
                witness = hibiki_witness(state, pcm[None, None])
                phase("hibiki", f"plain witness: the text logits of the first "
                      f"{witness['steps']} temporal steps with the kernels against the same "
                      f"inputs through the plain GEMVs: ||d|| / ||plain|| "
                      f"{witness['norm_rel_err']:.3e} (bound {HIBIKI_WITNESS_BOUND:.0e}), "
                      f"max rel {witness['max_rel_err']:.3e}; greedy text token equal in "
                      f"{witness['same_argmax_steps']} of {witness['steps']}")
                if witness["norm_rel_err"] > HIBIKI_WITNESS_BOUND:
                    raise RuntimeError("hibiki: the kernels' text logits leave the plain "
                                       "witness's bound")
            del state, outs
            free_memory()
        if not np.array_equal(texts[0], texts[1]):
            raise RuntimeError("hibiki: run (a) twice gave different tokens")
    finally:
        shutil.rmtree(HIBIKI_DIR, ignore_errors=True)
    free_memory()
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values()) for k in counters()}
    return {"runs": runs, "witness": witness, "checkpoint_gb": written["bytes"] / 1e9,
            "peak_gib": peak, "launches": launches,
            "per_step": {f"hibiki_b{rows}": expected[rows] for rows in HIBIKI_ROWS}}


HELIUM_DIR = ROOT / "build" / "helium_checkpoint"
# Helium-1 preview 2B (kyutai/helium-1-preview-2b): bench.py's moshi_2b
# temporal stack and scripts/import_helium.py's defaults.  Its linears are
# Hibiki-2B's temporal ones: 97 a step, 4 a layer and the 48000-column head
HELIUM_Q4_SHAPES = HIBIKI_Q4_SHAPES
HELIUM_PROMPT = 203       # prompt tokens: a multiple of neither 16 nor 128
HELIUM_STEPS = 128        # tokens of each run
HELIUM_PROFILED = 33      # tokens of the profiled eager run (32 decode steps)
# ||logits(kernels) - logits(plain)|| / ||logits(plain)|| of the prefill's
# last position, at most (PERF.md §6, stated before the first run)
HELIUM_WITNESS_BOUND = HIBIKI_WITNESS_BOUND


def helium_config():
    """Helium-1 preview 2B's LM: dim 2560, 24 layers, 20 heads of 128,
    FFN 7040, text card 48000, context 4096, rope max_period 100000; no
    audio codebooks, no depformer (import_helium.py's config)."""
    from moshi_tpu_torch.models.lm import LmConfig

    return LmConfig(dim=2560, num_heads=20, num_layers=24, hidden_scale=4.125, kv_repeat=1,
                    n_q=0, dep_q=0, card=0, text_card=48000, context=4096,
                    max_period=100_000.0, gating="silu", norm="rms_norm_f32",
                    positional_embedding="rope", delays=(0,), depformer_dim=0,
                    depformer_num_heads=1, depformer_num_layers=0,
                    depformer_multi_linear=False, depformer_weights_per_step=False)


def helium_expected(rows: int) -> dict:
    """Launches of one forward_text_step of `rows` rows: each q4 linear on
    the kernel q4matmul.route picks for bf16 x of that many rows."""
    from moshi_tpu_torch.ops import q4matmul

    out = dict.fromkeys(counters(), 0)
    for (_, dout), n in HELIUM_Q4_SHAPES.items():
        out[q4matmul.route(rows, torch.bfloat16, 32, dout)] += n
    return out


def write_helium_checkpoint(dev, out: Path) -> int:
    """Seeded Helium-1 2B, q4 (group 32) on the 96 layer linears and the
    head, written as a native checkpoint with a config.json of model_type
    helium and a synthetic tokenizer of the 48000 text pieces.  Returns
    the bytes of the weights."""
    import dataclasses
    from moshi_tpu_torch.models.lm import LMModel
    from moshi_tpu_torch.models.native_ckpt import save_params
    from moshi_tpu_torch.text.spm import spm_model_bytes
    from moshi_tpu_torch.utils.quantize import QTensor4, quantize_lm_params

    t0 = time.perf_counter()
    cfg = helium_config()
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    params = quantize_lm_params(LMModel(cfg).init_params(g, torch.bfloat16, dev), mode="int4")
    layers = params["transformer"]["layers"]
    linears = [layers["attn"]["in_proj"], layers["attn"]["out_proj"],
               layers["mlp"]["linear_in"], layers["mlp"]["linear_out"],
               params["text_linear"]["weight"]]
    if not all(isinstance(w, QTensor4) for w in linears):
        raise RuntimeError("helium: a linear of the quantized tree is not q4")
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    nbytes = save_params(out / "model.q4.native.safetensors", params)
    (out / "tokenizer.model").write_bytes(spm_model_bytes(cfg.text_card))
    config = {k: list(v) if isinstance(v, tuple) else v
              for k, v in dataclasses.asdict(cfg).items()}
    config.update(moshi_name="model.q4.native.safetensors", tokenizer_name="tokenizer.model",
                  model_type="helium", native_format=True)
    (out / "config.json").write_text(json.dumps(config, indent=2))
    tc = cfg.transformer_config
    phase("helium", f"Helium-1 2B q4 (dim {cfg.dim}, {cfg.num_layers} layers, {cfg.num_heads} "
          f"heads x {tc.head_dim}, kv_repeat {cfg.kv_repeat}, FFN {tc.hidden}, text card "
          f"{cfg.text_card}, context {cfg.context}, rope {cfg.max_period:g}) built from seed "
          f"{SEED + 23} in {built:.1f} s; written as a native checkpoint of "
          f"{nbytes / 1e9:.3f} GB in {time.perf_counter() - t0 - built:.1f} s")
    del params, layers, linears
    free_memory()
    return nbytes


@contextmanager
def text_step_launches():
    """LMModel.forward_text_step recorded while entered: each call's rows
    and the kernel launches it made, read from the host counters with no
    sync (a call may be a capture)."""
    from moshi_tpu_torch.models.lm import LMModel

    calls, fns, original = [], counters(), LMModel.forward_text_step

    def recorded(self, params, tr_state, sequence, *args, **kwargs):
        before = {name: fn.launches for name, fn in fns.items()}
        out = original(self, params, tr_state, sequence, *args, **kwargs)
        calls.append((sequence.shape[-1],
                      {name: fn.launches - before[name] for name, fn in fns.items()}))
        return out

    LMModel.forward_text_step = recorded
    try:
        yield calls
    finally:
        LMModel.forward_text_step = original


def check_helium_calls(calls, launches: dict, graphed: bool, what: str) -> None:
    """A generate_text run's forward_text_step calls: the prefill of
    HELIUM_PROMPT rows first, then one row a call, each with exactly the
    launches its rows imply; graphed, two calls only (the warm-up and the
    capture: the other steps are replays); nothing launched outside."""
    steps = 2 if graphed else HELIUM_STEPS - 1
    if [rows for rows, _ in calls] != [HELIUM_PROMPT] + [1] * steps:
        raise RuntimeError(f"{what}: forward_text_step calls of rows "
                           f"{[rows for rows, _ in calls]}")
    if calls[0][1] != helium_expected(HELIUM_PROMPT):
        raise RuntimeError(f"{what}: the prefill launched {calls[0][1]}")
    if any(delta != helium_expected(1) for _, delta in calls[1:]):
        raise RuntimeError(f"{what}: a decode step launched {calls[1][1]}")
    if launches != {k: sum(d[k] for _, d in calls) for k in launches}:
        raise RuntimeError(f"{what}: kernels launched outside forward_text_step: {launches}")


def helium_cli(dev, args: list) -> dict:
    """run_helium.main over HELIUM_DIR (the CLI in-process, its print
    captured): tokens, stats, the calls' launches, peak GiB, seconds."""
    from moshi_tpu_torch import run_helium

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    stats, printed = {}, io.StringIO()
    t0 = time.perf_counter()
    with text_step_launches() as calls, redirect_stdout(printed):
        ids = run_helium.main(["--checkpoint-dir", str(HELIUM_DIR), "-n", str(HELIUM_STEPS),
                               "--device", str(dev), *args], stats=stats)
    wall = time.perf_counter() - t0
    launches = read_counts()
    return {"ids": ids, "stats": stats, "calls": calls, "launches": launches, "wall_s": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "printed": printed.getvalue()}


def step_summary(stats: dict, skip: int) -> dict:
    ms = np.asarray(stats["step_ms"][skip:])
    return {"prefill_ms": stats["prefill_ms"], "p50_ms": float(np.percentile(ms, 50)),
            "p90_ms": float(np.percentile(ms, 90)), "tokens_per_s": 1e3 / float(ms.mean())}


def run_helium(dev, card: str) -> dict:
    """Helium-1 2B through run_helium: the checkpoint written; (a) main
    greedy, graphed, twice over a HELIUM_PROMPT-token prompt; (b) the same
    ids through generate_text eagerly; the plain witness of the prefill's
    last logits; (c) main sampled at its defaults, twice, and the same
    draws through generate_text eagerly; a profiler pass over an eager run (the same launches as a graphed one's replays; no
    capture under the profiler).  The checkpoint is deleted."""
    from moshi_tpu_torch.models.loaders import CheckpointInfo
    from moshi_tpu_torch.run_helium import generate_text
    from moshi_tpu_torch.text.spm import SentencePieceTokenizer

    t_phase = time.perf_counter()
    try:
        nbytes = write_helium_checkpoint(dev, HELIUM_DIR)
        info = CheckpointInfo.from_dir(HELIUM_DIR)
        tok = SentencePieceTokenizer(info.tokenizer_path)
        text_card = helium_config().text_card
        words = np.random.RandomState(SEED + 24).randint(3, text_card, HELIUM_PROMPT)
        prompt = " ".join(f"w{i}" for i in words)
        ids = tok.encode(prompt)
        if ids != words.tolist():
            raise RuntimeError(f"helium: the prompt encodes to {len(ids)} ids, not its "
                               f"{HELIUM_PROMPT} words")
        prefill_calls, decode_calls = [], []

        def keep(calls):
            prefill_calls.extend(d for rows, d in calls if rows > 1)
            decode_calls.extend(d for rows, d in calls if rows == 1)

        # (a) the CLI, greedy, graphed, twice
        greedy = []
        for i in range(2):
            r = helium_cli(dev, ["--prompt", prompt, "--temp", "0"])
            check_helium_calls(r["calls"], r["launches"], True, f"helium (a) run {i + 1}")
            keep(r["calls"])
            if not (len(r["ids"]) == HELIUM_STEPS and r["printed"].startswith(prompt)
                    and all(0 <= t < text_card for t in r["ids"])):
                raise RuntimeError("helium (a): tokens out of range or the print wrong")
            greedy.append(r)
        if greedy[0]["ids"] != greedy[1]["ids"]:
            raise RuntimeError("helium (a): two greedy runs gave different tokens")
        graphed = step_summary(greedy[1]["stats"], 2)
        completion = r["printed"][len(prompt):].split()
        phase("helium", f"(a) run_helium.main --temp 0 -n {HELIUM_STEPS}, graphed, twice: "
              f"equal tokens ({' '.join(completion[:6])} ...); forward_text_step calls: the "
              f"prefill of {HELIUM_PROMPT} rows {greedy[1]['calls'][0][1]['q4_wgmma']} "
              f"q4_wgmma, the warm-up and the capture {helium_expected(1)['q4_gemv']} "
              f"q4_gemv each, {HELIUM_STEPS - 3} replays, nothing else; prefill "
              f"{graphed['prefill_ms']:.2f} ms, ms/token p50 {graphed['p50_ms']:.3f}, p90 "
              f"{graphed['p90_ms']:.3f}, {graphed['tokens_per_s']:.1f} tokens/s; peak "
              f"{greedy[1]['peak_gib']:.2f} GiB; {greedy[1]['wall_s']:.1f} s with the load "
              f"({card})")

        # (b) eager, the same ids
        lm, params = info.get_moshi(device=dev)
        zero_counts()
        stats = {}
        with text_step_launches() as calls:
            eager_ids = generate_text(lm, params, ids, HELIUM_STEPS,
                                      torch.Generator(device=dev).manual_seed(0), temp=0.0,
                                      graphed=False, stats=stats)
        check_helium_calls(calls, read_counts(), False, "helium (b)")
        keep(calls)
        if eager_ids != greedy[0]["ids"]:
            same = sum(a == b for a, b in zip(eager_ids, greedy[0]["ids"]))
            raise RuntimeError(f"helium (b): eager tokens differ from graphed ({same} of "
                               f"{HELIUM_STEPS} equal)")
        eager = step_summary(stats, 0)
        phase("helium", f"(b) generate_text graphed=False over the same ids: the graphed "
              f"tokens, {HELIUM_STEPS - 1} decode calls of {helium_expected(1)['q4_gemv']} "
              f"q4_gemv; prefill {eager['prefill_ms']:.2f} ms, ms/token p50 "
              f"{eager['p50_ms']:.3f}, p90 {eager['p90_ms']:.3f}, "
              f"{eager['tokens_per_s']:.1f} tokens/s ({card})")

        # the plain witness: the prefill's last logits, kernels against plain f32
        prompt_t = torch.tensor(ids, dtype=torch.long, device=dev)[None, None]
        logits = []
        for plain in (False, True):
            state = lm.transformer.init_state(1, torch.bfloat16, dev)
            with (plain_gemvs(f32=True) if plain else nullcontext()), \
                    text_step_launches() as calls:
                zero_counts()
                logits.append(
                    lm.forward_text_step(params, state, prompt_t)[1][0, 0, -1].float())
                launched = read_counts()
            if launched != (dict.fromkeys(launched, 0) if plain
                            else helium_expected(HELIUM_PROMPT)):
                raise RuntimeError(f"helium: the witness's {'plain' if plain else 'kernel'} "
                                   f"prefill launched {launched}")
            if not plain:
                keep(calls)
        got, want = logits
        witness = {"norm_rel_err": ((got - want).norm() / want.norm()).item(),
                   "max_rel_err": rel_err(got, want),
                   "same_argmax": bool(got.argmax() == want.argmax())}
        phase("helium", f"plain witness: the prefill's last-position logits ({HELIUM_PROMPT} "
              f"rows, {sum(HELIUM_Q4_SHAPES.values())} q4_wgmma) against the same weights "
              f"through the plain GEMVs in f32: "
              f"||d|| / ||plain|| {witness['norm_rel_err']:.3e} (bound "
              f"{HELIUM_WITNESS_BOUND:.0e}), max rel {witness['max_rel_err']:.3e}; greedy "
              f"token {'equal' if witness['same_argmax'] else 'DIFFERENT'}")
        if witness["norm_rel_err"] > HELIUM_WITNESS_BOUND:
            raise RuntimeError("helium: the kernels' logits leave the plain witness's bound")

        # (c) the CLI's sampling defaults (temp 0.7, top-k 50, generator seeded 0), twice
        sampled = [helium_cli(dev, ["--prompt", prompt]) for _ in range(2)]
        for r in sampled:
            check_helium_calls(r["calls"], r["launches"], True, "helium (c)")
            keep(r["calls"])
        if sampled[0]["ids"] != sampled[1]["ids"]:
            raise RuntimeError("helium (c): two sampled runs of one seed differ")
        # eager over the same ids and a generator seeded 0: a replay that drew
        # with the wrong generator state would still repeat itself, not this
        zero_counts()
        with text_step_launches() as calls:
            eager_sampled = generate_text(lm, params, ids, HELIUM_STEPS,
                                          torch.Generator(device=dev).manual_seed(0),
                                          temp=0.7, top_k=50, graphed=False)
        check_helium_calls(calls, read_counts(), False, "helium (c) eager")
        keep(calls)
        if eager_sampled != sampled[0]["ids"]:
            same = sum(a == b for a, b in zip(eager_sampled, sampled[0]["ids"]))
            raise RuntimeError(f"helium (c): eager sampled tokens differ from graphed ({same} "
                               f"of {HELIUM_STEPS} equal)")
        same = sum(a == b for a, b in zip(sampled[0]["ids"], greedy[0]["ids"]))
        phase("helium", f"(c) run_helium.main at its defaults (temp 0.7, top-k 50, generator "
              f"seeded 0), twice, and generate_text graphed=False on the same seed: equal "
              f"tokens, {same} of {HELIUM_STEPS} equal to the greedy ones; ms/token p50 "
              f"{step_summary(sampled[1]['stats'], 2)['p50_ms']:.3f} ({card})")

        # the card's time of the kernels, over an eager run
        with text_step_launches() as calls:
            prof = profile_frames(lambda i: generate_text(
                lm, params, ids, HELIUM_PROFILED, torch.Generator(device=dev).manual_seed(0),
                temp=0.0, graphed=False), 1)
        keep(calls)
        steps = HELIUM_PROFILED - 1
        per_kernel = prof["kernel_ms_per_frame"]
        profiled = {"decode_steps": steps, "busy_ms": prof["busy_ms_per_frame"],
                    "q4_gemv_ms_per_step": per_kernel.get("q4_gemv", 0.0) / steps,
                    "q4_wgmma_prefill_ms": per_kernel.get("q4_wgmma", 0.0),
                    "host_ms": prof["host_ms_per_frame"],
                    "top_device_ms": prof["top_device_ms_per_frame"]}
        phase("helium", f"profiler over an eager run ({HELIUM_PROMPT}-row prefill, {steps} "
              f"decode steps): card busy {profiled['busy_ms']:.2f} ms of "
              f"{profiled['host_ms']:.2f}; q4_gemv {profiled['q4_gemv_ms_per_step']:.3f} ms a "
              f"step ({sum(HELIUM_Q4_SHAPES.values())} launches), the prefill's q4_wgmma "
              f"{profiled['q4_wgmma_prefill_ms']:.3f}"
              f" ms; the most costly {json.dumps(profiled['top_device_ms'])}")
        del lm, params
    finally:
        shutil.rmtree(HELIUM_DIR, ignore_errors=True)
    free_memory()
    seconds = time.perf_counter() - t_phase
    phase("helium", f"phase {seconds:.1f} s")
    total = {k: sum(d[k] for d in prefill_calls) for k in counters()}
    decode = {k: sum(d[k] for d in decode_calls) for k in counters()}
    return {"checkpoint_gb": nbytes / 1e9, "graphed": graphed, "eager": eager,
            "witness": witness, "profile": profiled, "peak_gib": greedy[1]["peak_gib"],
            "prompt_tokens": HELIUM_PROMPT, "steps": HELIUM_STEPS, "phase_s": seconds,
            "launches": {"helium_prefill": total, "helium_decode": decode},
            "per_step": {"helium_prefill": helium_expected(HELIUM_PROMPT),
                         "helium_decode": helium_expected(1)}}


# the benchmark CLI's modes on the card, and the summary keys of the JAX
# function each runs (moshi_tpu/benchmark.py: bench_mimi_only, bench_paced,
# bench_asr with bench_asr_host_only's merged in by main)
BENCH_CLI_RUNS = {
    "mimi_only": ["--mimi-only", "--steps", "100"],
    "duplex": ["--mode", "duplex", "--model", "moshi_7b_int4", "--steps", "60"],
    "asr": ["--mode", "asr", "--batch", "64", "--kv-cache", "int8", "--mimi-dtype", "bf16",
            "--steps", "30"],
}
BENCH_CLI_KEYS = {
    "mimi_only": {"mimi_steps_per_s", "ms_per_step", "rtf"},
    "duplex": {"model", "steps", "frame_interval_ms", "p50_ms", "p90_ms", "max_ms", "realtime"},
    "asr": {"mode", "model", "batch", "mimi_chunks", "kv_cache", "context", "weights", "mimi",
            "steps", "p50_ms", "p90_ms", "ms_per_user_p50", "device_only_ms",
            "host_roundtrip_ms", "realtime", "realtime_device_only", "host_python_ms",
            "host_python_us_per_user", "msgs_per_step"},
}
ASR_WARM_FRAMES = 3       # StreamingASR.warmup's eager frames
BENCH_CLI_LOGS = ROOT / "build" / "bench_cli"  # --out event logs of the timed modes


def bench_cli_expected() -> dict:
    """Launches each mode's run implies: none for Mimi alone; for duplex
    (Moshi-7B q4 + int8 depformer at B = 1) the warm-up step and the
    capture, each [slice]'s per-step count; for asr (bf16 weights, int8
    KV) 16 K6 in each warm-up frame and in the capture."""
    from moshi_tpu_torch.models.lm import lm_config_asr_300m_202501
    from moshi_tpu_torch.ops import q4matmul

    none = dict.fromkeys(counters(), 0)
    step = dict(none)
    for (_, dout), n in Q4_SHAPES.items():
        step[q4matmul.route(1, torch.bfloat16, 32, dout)] += n
    for (din, dout), n in INT8_SHAPES.items():
        step[int8_route(1, din, dout)[0]] += n
    frame = {**none, "decode_attention_int8": lm_config_asr_300m_202501().num_layers}
    return {"mimi_only": (none, 0), "duplex": (step, 2), "asr": (frame, ASR_WARM_FRAMES + 1)}


def run_bench_cli(dev, card: str, slice_p50: float) -> dict:
    """moshi_tpu_torch.benchmark.main in-process, once per BENCH_CLI_RUNS
    mode, the launch counters read around each call: the printed JSON's
    keys equal the JAX function's, the launches what the mode implies.
    `timed_steps` is the count of the timed window's events in the --out
    log (asr's summary `steps` is the host-only pass's, as in the JAX
    package's main)."""
    from moshi_tpu_torch import benchmark

    t_phase = time.perf_counter()
    expected, runs, launches = bench_cli_expected(), {}, {}
    BENCH_CLI_LOGS.mkdir(parents=True, exist_ok=True)
    for name, argv in BENCH_CLI_RUNS.items():
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        printed = io.StringIO()
        log = BENCH_CLI_LOGS / f"{name}.json"
        out_arg = [] if name == "mimi_only" else ["--out", str(log)]
        t0 = time.perf_counter()
        with redirect_stdout(printed):
            out = benchmark.main([*argv, *out_arg, "--device", str(dev)])
        wall = time.perf_counter() - t0
        launched = read_counts()
        if json.loads(printed.getvalue().strip().splitlines()[-1]) != out:
            raise RuntimeError(f"bench_cli {name}: the printed line is not the summary")
        if set(out) != BENCH_CLI_KEYS[name]:
            raise RuntimeError(f"bench_cli {name}: keys {sorted(out)}")
        per, times = expected[name]
        check_counts(launched, per, times, f"bench_cli {name}")
        timed = len(json.loads(log.read_text())["events"]) if out_arg else int(argv[-1])
        runs[name] = {**out, "timed_steps": timed, "wall_s": wall,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        launches[name] = launched
        phase("bench_cli", f"benchmark.main {' '.join(argv)}: {json.dumps(out)}; "
              f"{timed} timed steps; launches "
              f"{ {k: v for k, v in launched.items() if v} } = {times} x "
              f"{ {k: v for k, v in per.items() if v} }; {wall:.1f} s, peak "
              f"{runs[name]['peak_gib']:.2f} GiB ({card})")
        free_memory()
    d = runs["duplex"]
    if not d["realtime"]:
        raise RuntimeError("bench_cli duplex: p90 above the frame interval")
    phase("bench_cli", f"duplex moshi_7b_int4 (f32 Mimi, three graphs, paced): p50 "
          f"{d['p50_ms']:.2f} ms, p90 {d['p90_ms']:.2f}, max {d['max_ms']:.2f}, realtime "
          f"{d['realtime']}; [slice]'s graphed p50 {slice_p50:.2f} ms (bf16 Mimi, one "
          f"session's frame); phase {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(BENCH_CLI_LOGS, ignore_errors=True)
    return {"runs": runs, "phase_s": time.perf_counter() - t_phase,
            "launches": {f"bench_cli_{k}": launches[k] for k in ("duplex", "asr")},
            "per_step": {f"bench_cli_{k}": expected[k][0] for k in ("duplex", "asr")}}


def build_asr(dev):
    """asr_300m_202501 at full width with the int8 KV cache and bf16
    weights (the text head's pad columns scaled by ASR_PAD_LOGIT_SCALE), the
    bf16 Mimi v0.1 with 32 codebooks and the `delay` condition, all from a
    seed.  Returns the models for asr_engine."""
    from dataclasses import replace

    from moshi_tpu_torch.conditioners import ConditionProvider, ContinuousAttributeConditioner
    from moshi_tpu_torch.models.asr import asr_sum_condition
    from moshi_tpu_torch.models.lm import LMModel, lm_config_asr_300m_202501
    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config

    t0 = time.perf_counter()
    cfg = replace(lm_config_asr_300m_202501(), kv_cache_dtype="int8")
    lm = LMModel(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    lm_params = lm.init_params(g, torch.bfloat16, dev)
    for token, factor in ASR_PAD_LOGIT_SCALE.items():
        lm_params["text_linear"]["weight"][:, token] *= factor
    mimi = MimiModel(mimi_v0_1_config(cfg.n_q))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    provider = ConditionProvider({"delay": ContinuousAttributeConditioner(
        output_dim=cfg.dim, dim=ASR_COND["dim"], scale_factor=ASR_COND["scale_factor"],
        max_period=ASR_COND["max_period"])})
    cond_params = provider.init_params(g, torch.float32, dev)
    cond = asr_sum_condition(provider, cond_params, cfg.dim,
                             conditioning_delay=ASR_COND["delay"])
    torch.cuda.synchronize()
    phase("asr", f"asr_300m_202501 bf16 (dim {cfg.dim}, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads x {cfg.transformer_config.head_dim}, n_q {cfg.n_q}, ctx "
          f"{cfg.context}) + Mimi bf16 with {mimi.num_codebooks} codebooks built from seed "
          f"{SEED + 3} in {time.perf_counter() - t0:.1f} s")
    return {"mimi": mimi, "lm": lm, "mimi_params": mimi_params, "lm_params": lm_params,
            "cond": cond, "cond_params": cond_params}


def asr_engine(dev, models, batch: int, graphed: bool):
    """A warmed-up BatchedAsrState at B = batch over a StreamingASR of the
    models (graphed: Mimi encode and the temporal step as CUDA graphs)."""
    from moshi_tpu_torch.models.asr import StreamingASR
    from moshi_tpu_torch.serve.batched_asr import BatchedAsrState

    asr = StreamingASR(models["mimi"], models["lm"], batch, asr_delay_in_tokens=ASR_DELAY,
                       temperature=0.0, mimi_dtype=torch.bfloat16, sum_condition=models["cond"],
                       device=dev, graphed=graphed)
    if asr.graphed != graphed:
        raise RuntimeError(f"StreamingASR on the card: graphed {asr.graphed}")
    state = BatchedAsrState(asr, models["mimi_params"], models["lm_params"])
    state.warmup()
    torch.cuda.synchronize()
    return state


def reckoned_kv_gib(cfg, batch: int) -> float:
    """The int8 K and V caches and their bf16 scales at B = batch."""
    tc = cfg.transformer_config
    rows = 2 * cfg.num_layers * batch * tc.kv_capacity * tc.num_kv_heads
    return rows * (tc.head_dim + 2) / 2 ** 30


# the resume within the asr greedy run: slot U sends slot 0's PCM with a
# pause on ticks 15-16; slot S sends the same until its session leaves at
# tick 15, then a new tenant joins slot S (tick 16) with PCM of its own; the
# session resumes on slot R at tick 17 and goes on with U.  Two more ticks
# let U and R reach slot 0's 40 frames.
ASR_RESUME = {"U": 5, "S": 6, "R": 7, "leave": 15, "resume": 17, "extra_ticks": 2}


def asr_script(frame_size: int, slots: int):
    """The batched phase's isolation script at B = slots with ASR_RESUME:
    (schedule, frames)."""
    schedule, frames, _ = isolation_script(frame_size, slots)
    schedule = [dict(t) for t in schedule[:FRAMES]]
    u, s, r = ASR_RESUME["U"], ASR_RESUME["S"], ASR_RESUME["R"]
    leave, resume = ASR_RESUME["leave"], ASR_RESUME["resume"]
    ref = frames[0]
    tenant = np.random.RandomState(SEED + 8).randn(FRAMES, frame_size).astype(np.float32)
    frames[u], frames[s], frames[r] = ref, np.concatenate([ref[:leave], tenant]), ref[leave:]
    schedule += [{} for _ in range(ASR_RESUME["extra_ticks"])]
    for i, tick in enumerate(schedule):
        for slot in (u, s, r):
            tick.pop(slot, None)
        if i < FRAMES:
            if not leave <= i < resume:
                tick[u] = "join" if i == 0 else "send"
            if i <= leave:
                tick[s] = "join" if i == 0 else "send" if i < leave else "leave"
        else:
            tick[u] = "send"
        if i > leave:
            tick[s] = "join" if i == leave + 1 else "send"
        if i >= resume:
            tick[r] = ("resume", s) if i == resume else "send"
    return schedule, frames


def asr_leaves(state) -> list:
    """Every tensor of a BatchedAsrState's streaming state, in a fixed
    order."""
    return tensor_leaves([state.state["mimi"], state.state["transformer"]])


def same_bytes(a, b) -> bool:
    """Equal bit for bit, NaN included (a slot frozen at offset 0 writes NaN
    rows into Mimi's KV cache, as the JAX package's does)."""
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def asr_greedy(dev, models, graphed: bool):
    """A warmed-up engine at B = ASR_SLOTS, then the greedy run of
    asr_script, one frame per tick, with the launches counted.  Returns
    (state, sessions, ms, launches)."""
    from moshi_tpu_torch.serve.batched_asr import serve_asr

    state = asr_engine(dev, models, ASR_SLOTS, graphed)
    schedule, frames = asr_script(state.frame_size, ASR_SLOTS)
    ptrs = [t.data_ptr() for t in asr_leaves(state)]
    zero_counts()
    sessions, ms = serve_asr(state, schedule, frames)
    launches = read_counts()
    if [t.data_ptr() for t in asr_leaves(state)] != ptrs:
        raise RuntimeError("asr: a reset or a restore moved a state tensor")
    return state, sessions, ms, launches


def asr_runs(dev, models, graphed: bool):
    """One engine at B = ASR_SLOTS: its greedy run, then 10 frames of every
    slot sending and a profiler pass over 5 more.  Returns (state, summary
    with the peak memory over the engine's life so far: allocated, and
    above what was allocated before it)."""
    free_memory()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state, sessions, ms, launches = asr_greedy(dev, models, graphed)
    if graphed:
        kv = state.state["transformer"]
        phase("asr", f"B = {ASR_SLOTS}, int8 KV cache {tuple(kv['k'].shape)} x 2 + bf16 scales "
              f"{tuple(kv['k_scale'].shape)}; {(torch.cuda.memory_allocated(dev) - before) / 2**30:.2f} "
              f"GiB for the engine")
        del kv
    # the resumed session against the unbroken slot, before they part
    u, r = ASR_RESUME["U"], ASR_RESUME["R"]
    resume = {"rows_equal": all(same_bytes(a, b) for a, b in zip(*(
        tensor_leaves(state.asr.extract_slot_arrays(state.state, slot)) for slot in (u, r)))),
        "clock": state.asr.items[r].step_idx, "resumed": state.slot_resumed.get(r),
        "left_at": ASR_RESUME["leave"], "resumed_at": ASR_RESUME["resume"]}
    every = every_slot_asr(state, SEED + 4, 10, True)
    peak = torch.cuda.max_memory_allocated(dev)
    return state, {"sessions": sessions, "ms": ms, "launches": launches, "resume": resume,
                   "every_slot": every, "peak_gib": peak / 2 ** 30,
                   "engine_peak_gib": (peak - before) / 2 ** 30}


def words(msgs):
    return [m for m in msgs if m["type"] in ("Word", "EndWord")]


def check_asr_sessions(cfg, sessions, ms) -> dict:
    """The greedy run's checks: token ranges and Word / EndWord messages,
    slots 1-4 and U repeating slot 0, the resumed session (S then R)
    repeating slot 0, other slots differing.  Returns what it counted."""
    B = len(sessions)
    u, s, r = ASR_RESUME["U"], ASR_RESUME["S"], ASR_RESUME["R"]
    ref = sessions[0][0][0]
    if len(ms) != FRAMES + ASR_RESUME["extra_ticks"] or len(ref) != FRAMES:
        raise RuntimeError(f"asr: {len(ms)} frames, slot 0 has {len(ref)} tokens")
    said = {"Word": 0, "EndWord": 0}
    for slot in range(B):
        for tokens, msgs in sessions[slot]:
            if not ((tokens >= 0).all() and (tokens < cfg.text_card).all()):
                raise RuntimeError(f"asr slot {slot}: text token out of range")
            for m in msgs:
                said[m["type"]] = said.get(m["type"], 0) + 1
    if not (said["Word"] and said["EndWord"]):
        raise RuntimeError(f"asr: no Word or no EndWord message came out: {said}")
    ref_words = words(sessions[0][0][1])
    if not ref_words:
        raise RuntimeError("asr: slot 0 said no word, so its copies have nothing to repeat")
    (left_t, left_m), _ = sessions[s]
    (resumed_t, resumed_m), = sessions[r]
    copies = {**{slot: sessions[slot][i] for slot, (i, _) in SAME_AS_0.items()},
              u: sessions[u][0],
              "resumed": (np.concatenate([left_t, resumed_t]), left_m + resumed_m)}
    executed = {**{slot: n for slot, (_, n) in SAME_AS_0.items()}, u: FRAMES,
                "resumed": FRAMES}
    for slot, (got, msgs) in copies.items():
        if len(got) != executed[slot] or not np.array_equal(got, ref[:len(got)]):
            raise RuntimeError(f"asr: slot {slot} does not repeat slot 0's text tokens")
        # a slot that executed fewer frames said what slot 0 said in them
        got_words = words(msgs)
        if got_words != ref_words[:len(got_words)] or (
                executed[slot] == FRAMES and got_words != ref_words):
            raise RuntimeError(f"asr: slot {slot} does not repeat slot 0's Word / EndWord "
                               f"messages")
    if len(left_t) != ASR_RESUME["leave"]:
        raise RuntimeError(f"asr: the session left after {len(left_t)} frames")
    distinct = sum(not np.array_equal(sessions[slot][0][0], ref) for slot in range(8, B))
    if distinct == 0:
        raise RuntimeError("asr: no slot with its own PCM differs from slot 0")
    return {"said": said, "ref_words": len(ref_words), "distinct": distinct}


def every_slot_asr(state, seed: int, frames: int, profile: bool):
    """Every slot of an engine sends `frames` frames of unit-RMS noise, one
    tick each: host ms per batched frame (the tick), the word trackers' host
    ms, then a profiler pass over 5 more frames when asked.  The engine's
    slots must all be open."""
    B, fs = state.batch_size, state.frame_size
    pcm = np.random.RandomState(seed).randn(frames + 5, B, fs).astype(np.float32)

    def run_frame(i):
        for slot in range(B):
            state.feed_pcm(slot, pcm[i, slot])
        state.tick()
    full, host = [], []
    for i in range(frames):
        run_frame(i)
        full.append(state.frame_ms)
        host.append(state.asr.host_ms)
    out = {f"p{p}_ms": float(np.percentile(full, p)) for p in (50, 75, 90)}
    out["host_ms_p50"] = float(np.percentile(host, 50))
    out["frames"] = frames
    if profile:
        prof = profile_frames(lambda i: run_frame(frames + i), 5)
        # against the p50 of the same kind of frame, taken without the profiler
        prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / out["p50_ms"]
        out["profile"] = prof
    return out


def asr_sweep(dev, models, card: str) -> dict:
    """Graphed engines at ASR_SWEEP slots, every slot sending: one frame
    (the capture), then 20 timed; p50 / p90 ms per batched frame and peak
    memory at each B.  Names the largest B whose p90 stays under 80 ms."""
    cfg, out = models["lm"].config, {}
    for B in ASR_SWEEP:
        free_memory()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        state = asr_engine(dev, models, B, True)
        for slot in range(B):
            state.open_slot(slot)
        every_slot_asr(state, SEED + 9, 1, False)
        r = every_slot_asr(state, SEED + 10, 20, False)
        r["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        r["engine_peak_gib"] = r["peak_gib"] - before / 2 ** 30
        r["reckoned_kv_gib"] = reckoned_kv_gib(cfg, B)
        r["replays"] = state.asr.step.replays
        out[B] = r
        phase("asr", f"sweep B = {B}, graphed, 20 frames of every slot: p50 {r['p50_ms']:.2f} "
              f"ms, p90 {r['p90_ms']:.2f} ms per batched frame ({r['p50_ms'] / B:.4f} ms per "
              f"stream at p50); peak {r['peak_gib']:.2f} GiB allocated, {r['engine_peak_gib']:.2f} "
              f"GiB of it above what the card held before the engine, of that the int8 KV cache "
              f"and scales {r['reckoned_kv_gib']:.2f} GiB reckoned ({card})")
        del state
    real_time = [B for B, r in out.items() if r["p90_ms"] < 80.0]
    largest = max(real_time) if real_time else None
    phase("asr", f"sweep: the largest B of {list(ASR_SWEEP)} whose p90 stays under 80 ms: "
          f"{largest}")
    return {"by_batch": out, "largest_real_time_batch": largest}


def asr_plain_witness(dev, models, ref, ref_words) -> dict:
    """The greedy run eagerly with the plain attention in the kernel's
    place.  The seeded random model's text stream turns on near-ties, so
    the kernel's rounding can move it: slot 0 must say words with the plain
    attention too, so the pad factors do not rest on one kernel's rounding;
    the frames up to the streams' first difference are printed (graphed or
    not changes no bit)."""
    from moshi_tpu_torch.modules import transformer
    from moshi_tpu_torch.ops.decode_attention import decode_attention_int8_plain

    transformer.decode_attention_int8 = decode_attention_int8_plain
    try:
        _, sessions, _, launches = asr_greedy(dev, models, False)
    finally:
        transformer.decode_attention_int8 = counters()["decode_attention_int8"]
    plain_ref, plain_words = sessions[0][0][0], words(sessions[0][0][1])
    same = next((i for i in range(FRAMES) if plain_ref[i] != ref[i]), FRAMES)
    phase("asr", f"the greedy run with decode_attention_int8_plain in the kernel's place, "
          f"eager: slot 0 says {len(plain_words)} Word / EndWord messages (with the kernel "
          f"{len(ref_words)}); its text tokens equal the kernel run's for the first {same} of "
          f"{FRAMES} frames")
    if any(launches.values()):
        raise RuntimeError(f"asr: the plain run launched kernels: {launches}")
    if not plain_words:
        raise RuntimeError("asr: with the plain attention slot 0 said no word, so the Word "
                           "check rests on the kernel's rounding")
    return {"words": len(plain_words), "same_tokens_frames": same}


def run_asr(dev, card: str) -> dict:
    """The batched STT path at B = ASR_SLOTS: the greedy run of asr_script
    graphed (the main path), then every slot sending; the same on an eager
    engine, the two held equal; the greedy run eagerly with the plain
    attention in the kernel's place; then the batch sweep, graphed."""
    models = build_asr(dev)
    cfg, B = models["lm"].config, ASR_SLOTS
    expected = {name: 0 for name in TPU_KERNELS}
    expected["decode_attention_int8"] = cfg.num_layers
    state, g = asr_runs(dev, models, True)
    eager, e = asr_runs(dev, models, False)
    ms, sessions = g["ms"], g["sessions"]
    check_counts(g["launches"], expected, 1, "asr greedy graphed run (the captured step)")
    check_counts(e["launches"], expected, len(e["ms"]), "asr greedy eager run")
    replays = {"encode": state.asr.encode.replays, "step": state.asr.step.replays}
    if replays != {"encode": len(ms) + 15, "step": len(ms) + 15}:
        raise RuntimeError(f"asr: replays {replays} for {len(ms)} + 15 frames")
    counted = check_asr_sessions(cfg, sessions, ms)
    u, r = ASR_RESUME["U"], ASR_RESUME["R"]
    rows_equal = g["resume"]["rows_equal"]
    resumed = g["resume"]["resumed"] and g["resume"]["clock"] == FRAMES
    same_tokens = all(len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))
        for a, b in zip(sessions.values(), e["sessions"].values()))
    same_state = all(same_bytes(a, b) for a, b in zip(asr_leaves(state), asr_leaves(eager)))
    del state, eager
    p50, p75, p90 = (float(np.percentile(ms, p)) for p in (50, 75, 90))
    e50, e90 = (float(np.percentile(e["ms"], p)) for p in (50, 90))
    phase("asr", f"greedy, {len(ms)} frames x {B} slots graphed: slots 1 (same PCM), 2 (joined "
          f"5 frames late), 3 (frozen on frames 10-14), 4 (reset at frame 20) and {u} (paused on "
          f"ticks 15-16) repeat slot 0's text tokens and its {counted['ref_words']} Word / "
          f"EndWord messages, and so does the session that left slot {ASR_RESUME['S']} at "
          f"frame {ASR_RESUME['leave']} and resumed on slot {r} after a new tenant took slot "
          f"{ASR_RESUME['S']}; its device rows at the end "
          f"{'equal' if rows_equal else 'DIFFER from'} slot {u}'s, bit for bit; "
          f"{counted['distinct']} of {B - 8} other slots differ; messages by type "
          f"{counted['said']}; launches {g['launches']} = per step {expected} x 1 captured "
          f"step, replays {replays} (with 15 frames of every slot); eager launches "
          f"{e['launches']} = x {len(e['ms'])}; graphed against eager: text tokens and messages "
          f"{'equal' if same_tokens else 'DIFFER'}, every state byte after the same frames "
          f"{'equal' if same_state else 'DIFFERS'}")
    if not (rows_equal and resumed):
        raise RuntimeError("asr: the resumed session's rows or clock differ from the unbroken "
                           "slot's")
    if not (same_tokens and same_state):
        raise RuntimeError("asr: the graphed frames differ from the eager ones")
    phase("asr", f"greedy run: graphed p50 {p50:.2f} ms, p75 {p75:.2f} ms, p90 {p90:.2f} ms per "
          f"batched frame (the capture's frame included), {p50 / B:.4f} ms per stream at p50; "
          f"eager p50 {e50:.2f} ms, p90 {e90:.2f} ms ({card})")
    for kind, run in (("graphed", g), ("eager", e)):
        every = run["every_slot"]
        phase("asr", f"all {B} slots, 10 frames {kind}: p50 {every['p50_ms']:.2f} ms, p75 "
              f"{every['p75_ms']:.2f} ms, p90 {every['p90_ms']:.2f} ms per batched frame, "
              f"{every['p50_ms'] / B:.4f} ms per stream at p50, of it {every['host_ms_p50']:.2f} "
              f"ms of host Python in the per-slot input and word-tracker loops; peak "
              f"{run['peak_gib']:.2f} GiB allocated, {run['engine_peak_gib']:.2f} GiB of it "
              f"above what the card held before the engine; profiler over 5 frames: "
              f"{profile_line(every['profile'])} ({card})")
    witness = asr_plain_witness(dev, models, sessions[0][0][0], words(sessions[0][0][1]))
    sweep = asr_sweep(dev, models, card)
    t0 = time.perf_counter()
    nbytes = write_asr_checkpoint(models, ASR_DIR)
    phase("asr", f"wrote the weights as a native checkpoint for [worker]: {nbytes / 1e9:.3f} GB "
          f"in {time.perf_counter() - t0:.2f} s -> {ASR_DIR}")
    del models
    free_memory()
    summary = {key: v for key, v in g.items() if key != "sessions"}
    summary.update({"per_frame": expected, "replays": replays, "p50_ms": p50, "p75_ms": p75,
                    "p90_ms": p90, "frames": len(ms),
                    "eager": {key: v for key, v in e.items() if key not in ("sessions", "ms")},
                    "sweep": sweep, "plain_witness": witness})
    summary["eager"].update({"p50_ms": e50, "p90_ms": e90})
    del summary["ms"]
    return summary


# ----------------------------------------------------------------- worker
ASR_DIR = ROOT / "build" / "asr_checkpoint"
WORKER_ASR_SLOTS = 64     # B of the worker's batched_asr module
WORKER_ASR_CLIENTS = 16   # msgpack clients; one more speaks the legacy framing
WORKER_MARKERS = (10, 20, 30)  # a client sends a Marker before these frames
WORKER_LEAVE = 15         # the resuming ASR client and batched slot leave after this frame
WORKER_TIMEOUT = 120      # seconds a client waits for the loop


def write_asr_checkpoint(models, out: Path) -> int:
    """[asr]'s seeded weights as a native speech-to-text checkpoint: the LM
    (bf16, the head's pad columns scaled) with the `delay` conditioner's
    tensors under their PyTorch names in the same file, the bf16 Mimi
    (v0.1, 32 codebooks), a synthetic tokenizer of the text vocabulary and
    a config.json with stt_config and the conditioners block.  Returns the
    bytes of the weights."""
    import dataclasses
    from moshi_tpu_torch.models.native_ckpt import flatten_tree, save_mimi_params
    from moshi_tpu_torch.text.spm import spm_model_bytes
    from moshi_tpu_torch.utils.safetensors import save_file

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    lm, cfg = models["lm"], models["lm"].config
    flat = flatten_tree(models["lm_params"])
    prefix = "condition_provider.conditioners.delay"
    flat[f"{prefix}.output_proj.weight"] = models["cond_params"]["delay"]["output_proj"].t()
    flat[f"{prefix}.learnt_padding"] = models["cond_params"]["delay"]["learnt_padding"]
    nbytes = save_file(flat, out / "model.native.safetensors")
    nbytes += save_mimi_params(out / "mimi.native.safetensors", models["mimi"],
                               models["mimi_params"])
    (out / "tokenizer.model").write_bytes(spm_model_bytes(cfg.text_card))
    config = {k: list(v) if isinstance(v, tuple) else v
              for k, v in dataclasses.asdict(cfg).items()}
    cond = {k: ASR_COND[k] for k in ("dim", "scale_factor", "max_period")}
    config.update(moshi_name="model.native.safetensors", mimi_name="mimi.native.safetensors",
                  tokenizer_name="tokenizer.model", model_type="stt", native_format=True,
                  stt_config={"audio_delay_seconds": ASR_DELAY / 12.5,
                              "audio_silence_prefix_seconds": STT_SILENCE_PREFIX,
                              "conditioning_delay": ASR_COND["delay"]},
                  conditioners={"delay": {"type": "continuous_attribute",
                                          "continuous_attribute": cond}})
    (out / "config.json").write_text(json.dumps(config, indent=2))
    del lm
    return nbytes


STT_SECONDS = 4            # seeded PCM of the [stt] run
STT_SILENCE_PREFIX = 0.5   # stt_config's audio_silence_prefix_seconds


def run_stt(dev, card: str) -> dict:
    """Speech-to-text through run_inference's CLI over [asr]'s checkpoint
    (bf16 asr_300m_202501, int8 KV, stt_config's pads), B = 1, greedy:
    one LMGen.step a padded frame (the first frame twice), 16
    decode_attention_int8 launches a step and no GEMV, text tokens in
    range."""
    from moshi_tpu_torch import audio, run_inference

    wav = ASR_DIR / "stt_in.wav"
    pcm = (0.3 * np.random.RandomState(SEED + 7).randn(STT_SECONDS * 24000)).astype(np.float32)
    audio.write_wav(wav, pcm, 24000)
    info = json.loads((ASR_DIR / "config.json").read_text())
    stt = info["stt_config"]
    padded = (pcm.size + int(stt["audio_silence_prefix_seconds"] * 24000)
              + int((stt["audio_delay_seconds"] + 1.0) * 24000))
    zero_counts()
    t0 = time.perf_counter()
    state, outs = run_inference.main(["--checkpoint-dir", str(ASR_DIR), "--device", str(dev),
                                      str(wav)])
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = state.stats
    expected = dict.fromkeys(launches, 0)
    expected["decode_attention_int8"] = state.lm.config.num_layers
    check_counts(launches, expected, st["lm_steps"], "stt")
    text = outs[0][0]
    frames = padded // state.mimi.frame_size
    if st["steps"] != frames or len(text) != frames or st["lm_steps"] != frames + 1:
        raise RuntimeError(f"stt: {st['steps']} steps and {len(text)} tokens for "
                           f"{frames} padded frames")
    if not ((text >= 0) & (text < state.lm.config.text_card)).all():
        raise RuntimeError("stt: text token out of range")
    ms = np.asarray(st["step_ms"])
    p50, p90 = float(np.percentile(ms, 50)), float(np.percentile(ms, 90))
    phase("stt", f"run_inference.main over the asr checkpoint (model_type stt, pads "
          f"{stt['audio_silence_prefix_seconds']} s + {STT_SECONDS} s + "
          f"{stt['audio_delay_seconds'] + 1.0:.2f} s): {st['steps']} steps = padded frames, "
          f"{len(text)} text tokens in range; ms/step p50 {p50:.2f}, p90 {p90:.2f}; launches "
          f"{ {k: v for k, v in launches.items() if v} } = "
          f"{expected['decode_attention_int8']} x {st['lm_steps']}; "
          f"{wall:.1f} s with the load ({card})")
    del state
    free_memory()
    return {"steps": st["steps"], "lm_steps": st["lm_steps"], "p50_ms": p50, "p90_ms": p90,
            "wall_s": wall, "launches": launches, "per_step": expected}


def worker_toml() -> str:
    return f"""
authorized_ids = ["smoke"]

[modules.chat]
type = "moshi"
route = "/api/chat"
checkpoint_dir = "{SERVE_DIR}"

[modules.batched]
type = "batched_moshi"
route = "/api/batched"
checkpoint_dir = "{SERVE_DIR}"
batch_size = {SLOTS}
kv_cache = "int4"
mimi_dtype = "bf16"

[modules.asr]
type = "batched_asr"
route = "/api/asr-streaming"
checkpoint_dir = "{ASR_DIR}"
batch_size = {WORKER_ASR_SLOTS}
asr_delay_in_tokens = {ASR_DELAY}
conditioning_delay = {ASR_COND["delay"]}
kv_cache = "int8"
mimi_dtype = "bf16"
"""


def worker_asr_pcm(frame_size: int) -> np.ndarray:
    """[WORKER_ASR_CLIENTS // 2, FRAMES, frame_size]: one stream per twin
    pair, unit-RMS noise (a quiet random Mimi maps noise to one code)."""
    rs = np.random.RandomState(SEED + 50)
    return rs.randn(WORKER_ASR_CLIENTS // 2, FRAMES, frame_size).astype(np.float32)


async def asr_client(http, url: str, frames, legacy: bool, asr, leave: bool) -> list:
    """One ASR client: Init, then its frames as fast as the socket takes them
    with a Marker (id = the frame's index) before WORKER_MARKERS; with
    `leave`, after WORKER_LEAVE frames it waits for the loop to have run
    them, reads what came, leaves, and resumes under its resume id for the
    rest.  Returns the messages received, in order."""
    from moshi_tpu_torch.serve.msgpack_codec import packb, unpackb

    async def connect(params):
        ws = await http.ws_connect(url, params=params, headers={"kyutai-api-key": "smoke"})
        ready = unpackb(await ws.receive_bytes(timeout=WORKER_TIMEOUT))
        if ready.get("type") != "Ready":
            raise RuntimeError(f"worker asr: {ready}")
        return ws, ready

    async def read(ws, out, quiet: float):
        while True:
            try:
                m = await ws.receive_bytes(timeout=quiet)
            except asyncio.TimeoutError:
                return
            out.append(unpackb(m))

    async def stop(task):
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    ws, ready = await connect({"resume_support": "1"} if leave else {})
    out = []
    await ws.send_bytes(packb({"type": "Init"}))
    reader = asyncio.ensure_future(read(ws, out, WORKER_TIMEOUT))
    for k, frame in enumerate(frames):
        if leave and k == WORKER_LEAVE:
            slot = next(s for s, q in asr.slot_queues.items() if q is not None
                        and asr.slot_resume_id.get(s) == ready["resume_id"])
            while asr.slot_pcm[slot].shape[-1] >= asr.frame_size:
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.5)   # the frame in flight and its messages
            await stop(reader)
            await read(ws, out, 0.5)
            await ws.close()
            ws, back = await connect({"resume": ready["resume_id"]})
            if back.get("resumed") is not True:
                raise RuntimeError(f"worker asr: the session did not resume: {back}")
            reader = asyncio.ensure_future(read(ws, out, WORKER_TIMEOUT))
        if k in WORKER_MARKERS:
            await ws.send_bytes(packb({"type": "Marker", "id": k}))
        await ws.send_bytes(b"\x08" + frame.tobytes() if legacy
                            else packb({"type": "Audio", "pcm": frame.tolist()}))
    expected = len(WORKER_MARKERS)
    t0 = time.perf_counter()
    while sum(m["type"] == "Marker" for m in out) < expected:
        if reader.done():
            reader.result()
        if time.perf_counter() - t0 > WORKER_TIMEOUT:
            raise RuntimeError("worker asr: markers did not come back")
        await asyncio.sleep(0.01)
    await asyncio.sleep(0.5)
    await stop(reader)
    await read(ws, out, 0.5)
    await ws.close()
    return out


def asr_words(msgs) -> list:
    return [(m["type"], m.get("text"), m.get("start_time"), m.get("stop_time"))
            for m in msgs if m["type"] in ("Word", "EndWord")]


def markers_after_their_words(msgs) -> bool:
    """Every Marker (sent before frame `id`) comes after each EndWord whose
    stop_time is before id / 12.5 s: those words were said in the audio
    before it.  Markers come in order."""
    ids = [m["id"] for m in msgs if m["type"] == "Marker"]
    if ids != sorted(ids) or ids != list(WORKER_MARKERS):
        return False
    for i, m in enumerate(msgs):
        if m["type"] != "Marker":
            continue
        if any(e["type"] == "EndWord" and e["stop_time"] < m["id"] / 12.5
               for e in msgs[i + 1:]):
            return False
    return True


async def batched_sessions(state, frame_size: int) -> dict:
    """The batched Moshi module driven through its own acquire_slot /
    feed_pcm / slot_queues / release_slot, under the run_loop the worker
    started: 14 sessions in twin pairs of 40 frames of seeded PCM, and a
    fifteenth, the twin of the first, that leaves after WORKER_LEAVE
    frames with a resume id; a tenant then takes its slot for 5 frames, and
    the session resumes on the other free slot.  Returns each session's
    token rows [frames, 1 + dep_q] and the resume's slots."""
    rs = np.random.RandomState(SEED + 60)
    pcm = (0.1 * rs.randn(7, FRAMES, frame_size)).astype(np.float32)
    skip = 1 + state.lm.config.max_delay   # frames a fresh session yields nothing for
    sessions = [await state.acquire_slot() for _ in range(15)]
    tokens = {i: [] for i in range(15)}

    def take(i, slot):
        q = state.slot_queues[slot]
        while not q.empty():
            tokens[i].append(np.asarray(q.get_nowait()[1]))

    async def until(cond, what):
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > WORKER_TIMEOUT:
                raise RuntimeError(f"worker batched: timed out waiting for {what}")
            await asyncio.sleep(0.005)

    for i, slot in enumerate(sessions[:14]):
        state.feed_pcm(slot, pcm[i // 2].reshape(-1))
    left = sessions[14]
    rid = state.issue_resume_id(left)
    state.feed_pcm(left, pcm[0, :WORKER_LEAVE].reshape(-1))

    def count(i, slot):
        take(i, slot)
        return len(tokens[i])

    await until(lambda: count(14, left) == WORKER_LEAVE - skip, "the leaving session's frames")
    await state.release_slot(left)
    tenant = await state.acquire_slot()
    state.feed_pcm(tenant, pcm[3, :5].reshape(-1))
    back = await state.acquire_slot(rid)
    if not state.slot_resumed.get(back) or back == left:
        raise RuntimeError(f"worker batched: resume on slot {back} (left {left})")
    state.feed_pcm(back, pcm[0, WORKER_LEAVE:].reshape(-1))
    n = FRAMES - skip
    await until(lambda: all(count(i, s) == n for i, s in enumerate(sessions[:14]))
                and count(14, back) == n, "every session's frames")
    for slot in sessions[:14] + [back, tenant]:
        await state.release_slot(slot)
    return {"tokens": {i: np.stack(t) for i, t in tokens.items()},
            "left": left, "tenant": tenant, "back": back}


async def drive_worker(app, asr, batched, chat) -> dict:
    import aiohttp
    from aiohttp import web

    runner = web.AppRunner(app)
    await runner.setup()
    port = free_port()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}"
    key = {"kyutai-api-key": "smoke"}
    out = {}
    try:
        async with aiohttp.ClientSession() as http:
            r = await http.get(f"{base}/api/modules_info")
            out["unauthorized"] = r.status
            out["modules_info"] = await (await http.get(f"{base}/api/modules_info",
                                                        headers=key)).json()
            out["metrics"] = (await http.get(f"{base}/metrics")).status

            # ASR: the clients all at once; client 15 leaves and resumes,
            # client 16 (legacy framing) is client 0's twin
            pcm = worker_asr_pcm(asr.frame_size)
            url = f"{base}/api/asr-streaming"
            asr.frame_times.clear()
            t0 = time.perf_counter()
            clients = [asr_client(http, url, pcm[i // 2], False, asr, i == 15)
                       for i in range(WORKER_ASR_CLIENTS)]
            clients.append(asr_client(http, url, pcm[0], True, asr, False))
            out["asr"] = await asyncio.gather(*clients)
            out["asr_s"] = time.perf_counter() - t0
            out["asr_frame_ms"] = list(asr.frame_times)

            batched.frame_times.clear()
            out["batched"] = await batched_sessions(batched, batched.frame_size)
            out["batched_frame_ms"] = list(batched.frame_times)

            # Moshi: one raw-PCM session on /api/chat
            ws = await http.ws_connect(f"{base}/api/chat", headers=key)
            first = await ws.receive_bytes(timeout=SERVE_TIMEOUT)
            from moshi_tpu_torch.serve import protocol as proto
            if first != proto.handshake():
                raise RuntimeError(f"worker chat: handshake {first!r}")
            msgs, ms = await pcm_session(ws, serve_pcm(chat.frame_size))
            out["chat_tokens"] = np.array(chat.session_tokens)
            out["chat_ms"] = ms
            await ws.close()
    finally:
        await runner.cleanup()
    return out


def run_worker(dev, card: str, serve: dict, batched_p50: float) -> dict:
    """The worker's entry point on one TOML of three modules (the Moshi
    server over [serve]'s checkpoint, batched Moshi over the same one at
    B = SLOTS with the int4 KV cache, batched ASR over [asr]'s checkpoint at
    B = WORKER_ASR_SLOTS with the int8 KV cache), built by build_app as
    `main` builds it and served by aiohttp on 127.0.0.1: auth, modules_info
    and metrics; ASR clients over the socket (twins, a resume, markers, the
    legacy framing); the batched module's sessions (twins, a resume on
    another slot); one Moshi socket session against [serve]'s tokens.  The
    launches of the whole phase: every module's warm-up frames and its one
    capture, none while serving.  The checkpoints stay for [fleet]."""
    import tomllib
    import aiohttp
    from moshi_tpu_torch.serve.worker import build_app

    free_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    app = build_app(tomllib.loads(worker_toml()), device=dev)
    build_s = time.perf_counter() - t0
    built = read_counts()
    modules = app["modules"]
    chat, batched, asr = (modules[k]["state"] for k in ("chat", "batched", "asr"))
    for name, m in modules.items():
        phase("worker", f"module {name} ({m['type']}): loaded in {m['load_s']:.2f} s, "
              f"warm-up and captures {m['warmup_s']:.2f} s")

    # the launches of the build: each module's eager warm-up frames, then
    # one captured frame (its graphs), each the module's per-frame count
    moshi_step = per_step_launches(chat.lm.config, chat.lm_params, 1)
    batched_frame = per_step_launches(batched.lm.config, batched.lm_params, SLOTS)
    asr_step = dict.fromkeys(TPU_KERNELS, 0)
    asr_step["decode_attention_int8"] = asr.asr.lm.config.num_layers
    chat_frames = max(4, chat.lm.config.max_delay + 2) + 1
    expected = {k: moshi_step[k] * chat_frames + batched_frame[k] * 4 + asr_step[k] * 4
                for k in TPU_KERNELS}
    if built != expected:
        raise RuntimeError(f"worker: build launched {built}, expected {expected}")

    out = asyncio.run(drive_worker(app, asr, batched, chat))
    launches = read_counts()
    if launches != built:
        raise RuntimeError(f"worker: serving launched kernels outside the graphs: "
                           f"{launches} after the build's {built}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30

    info = out["modules_info"]
    want_info = {"chat": {"type": "moshi", "route": "/api/chat"},
                 "batched": {"type": "batched_moshi", "batch_size": SLOTS,
                             "route": "/api/batched"},
                 "asr": {"type": "batched_asr", "batch_size": WORKER_ASR_SLOTS,
                         "route": "/api/asr-streaming"}}
    if out["unauthorized"] != 401 or info != want_info or out["metrics"] != 200:
        raise RuntimeError(f"worker: auth {out['unauthorized']}, modules {info}, "
                           f"metrics {out['metrics']}")

    # ASR: twins, the resume, the legacy twin, markers after their words
    msgs = out["asr"]
    for i in range(0, WORKER_ASR_CLIENTS, 2):
        for a, b in ((i, i + 1),) + (((0, WORKER_ASR_CLIENTS),) if i == 0 else ()):
            if asr_words(msgs[a]) != asr_words(msgs[b]):
                raise RuntimeError(f"worker asr: clients {a} and {b} heard the same PCM "
                                   f"but said different words")
    said = sum(len(asr_words(m)) for m in msgs)
    if not asr_words(msgs[0]) or said == 0:
        raise RuntimeError("worker asr: no words")
    ordered = [markers_after_their_words(m) for m in msgs]
    if not all(ordered):
        raise RuntimeError(f"worker asr: markers out of order for clients "
                           f"{[i for i, ok in enumerate(ordered) if not ok]}")
    if any(m["type"] == "Error" for c in msgs for m in c):
        raise RuntimeError("worker asr: an Error message")
    frames = sum(FRAMES for _ in msgs)
    a50, a90 = (float(np.percentile(out["asr_frame_ms"], p)) for p in (50, 90))
    phase("worker", f"asr over the socket: {len(msgs)} clients x {FRAMES} frames "
          f"({WORKER_ASR_CLIENTS} msgpack, 1 legacy \\x08), twins said equal words (the "
          f"legacy client too), client 15 left after frame {WORKER_LEAVE} and resumed "
          f"with its twin's words; {said} Word / EndWord messages; every marker came "
          f"back after its words; {len(out['asr_frame_ms'])} batched frames at B = "
          f"{WORKER_ASR_SLOTS}: p50 {a50:.2f} ms, p90 {a90:.2f} ms; "
          f"{frames / out['asr_s']:.0f} client frames/s through the socket ({card})")

    # batched Moshi: twins and the resumed session
    b = out["batched"]
    tokens = b["tokens"]
    for i in range(0, 14, 2):
        if not np.array_equal(tokens[i], tokens[i + 1]):
            raise RuntimeError(f"worker batched: twin sessions {i} and {i + 1} differ")
    if not np.array_equal(tokens[14], tokens[0]):
        raise RuntimeError("worker batched: the resumed session differs from its twin")
    for t in tokens.values():
        check_tokens(t, batched.lm.config, "worker batched")
    m50, m90 = (float(np.percentile(out["batched_frame_ms"], p)) for p in (50, 90))
    phase("worker", f"batched_moshi B = {SLOTS} int4 KV through run_loop: 7 twin pairs "
          f"x {FRAMES} frames equal token for token; the session that left slot "
          f"{b['left']} after frame {WORKER_LEAVE} resumed on slot {b['back']} (a tenant "
          f"took slot {b['tenant']}) and repeats its twin; "
          f"{len(out['batched_frame_ms'])} frames p50 {m50:.2f} ms, p90 {m90:.2f} ms per "
          f"batched frame ([batched] graphed greedy p50 {batched_p50:.2f} ms in this run; "
          f"{card})")

    # Moshi over the socket against [serve]'s session 1
    if not np.array_equal(out["chat_tokens"], serve["greedy_tokens"]):
        raise RuntimeError("worker chat: the socket session's tokens differ from "
                           "[serve]'s")
    c50 = float(np.percentile(out["chat_ms"], 50))
    used = {k: v for k, v in built.items() if v}
    phase("worker", f"moshi over /api/chat: {len(out['chat_tokens'])} greedy token "
          f"frames equal [serve]'s session 1; p50 {c50:.2f} ms frame to PCM reply")
    phase("worker", f"build_app {build_s:.2f} s (aiohttp {aiohttp.__version__}); launches "
          f"{used} = warm-up + 1 captured frame of each module (chat "
          f"{chat_frames} steps, batched 4 frames, asr 4 steps), none while serving; "
          f"peak {peak:.2f} GiB allocated ({card})")
    seconds = {k: {"load_s": m["load_s"], "warmup_s": m["warmup_s"]}
               for k, m in modules.items()}
    del app, modules, chat, batched, asr
    return {"launches": launches, "build_s": build_s, "modules": seconds,
            "asr_p50_ms": a50, "asr_p90_ms": a90,
            "asr_client_frames_per_s": frames / out["asr_s"],
            "batched_p50_ms": m50, "batched_p90_ms": m90, "chat_p50_ms": c50,
            "peak_gib": peak,
            "per_frame": {"chat": moshi_step, "batched": batched_frame, "asr": asr_step}}


# ------------------------------------------------------------------ fleet
FLEET_DIR = ROOT / "build" / "fleet"
FLEET_FRAMES = 100        # a migrated session's frames after the skipped one
FLEET_KILL = 60           # the frame after which the session's first worker is killed
FLEET_REPLICATE = 25      # the fleet workers' replicate_every
FLEET_AUTH = "smoke-fleet"
FLEET_SAMPLED = {**SAMPLED, "text_seed": "5"}
FLEET_START_TIMEOUT = 240  # seconds a fleet process may take to come up
FLEET_DEVICE = "cuda"     # the workers' --device
VISION_LAYERS = 32        # lm_config_v0_1_vision's depth in [fleet] (b)
VISION_FRAMES = (10, 20, 10)  # frames before the first image, between the two, after
VISION_IMAGE = 16         # frames of an image's embeddings
PY_BASR_SLOTS = 16
PY_BASR_CLIENTS = 4
PY_BASR_FRAMES = 100      # seeded PCM frames a py_basr client sends before its Marker
PY_BASR_TAIL = ASR_DELAY + 4  # silent frames after the Marker, so the clock passes it

COUNTS_SCRIPT = '''
"""A `py` module of the [fleet] workers: its process's kernel launch counts."""
import chip_smoke


class App:
    async def handle(self, request):
        from aiohttp import web
        return web.json_response(chip_smoke.read_counts())


def init(batch_size, config):
    return App()
'''

# a py_batched_asr app over the port's StreamingASR, eager, the ASR
# checkpoint's knobs of [worker]: the bitmask step protocol of
# serve/py_basr.py; a slot's text token goes out once the slot has run
# asr_delay_in_tokens steps (before, a pad), as StreamingASR's words count
PY_BASR_SCRIPT = '''
"""py_batched_asr over StreamingASR (chip_smoke.py [fleet] (c))."""
import time

import numpy as np

ACTIVE, RESET = -1, -2


class App:
    def __init__(self, batch_size, config):
        from moshi_tpu_torch.models.asr import StreamingASR, asr_sum_condition
        from moshi_tpu_torch.models.loaders import CheckpointInfo
        from moshi_tpu_torch.utils.serving import apply_serving_overrides

        info = CheckpointInfo.from_dir(config["checkpoint_dir"])
        dev = config["device"]
        mimi, mimi_params = info.get_mimi(device=dev)
        lm, lm_params = info.get_moshi(device=dev)
        lm, self.lm_params, self.mimi_params, md = apply_serving_overrides(
            lm, lm_params, mimi_params, kv_cache=config["kv_cache"],
            mimi_dtype=config["mimi_dtype"])
        cond = asr_sum_condition(info, lm.config.dim, device=dev,
                                 conditioning_delay=config["conditioning_delay"])
        self.delay = int(config["asr_delay_in_tokens"])
        self.asr = StreamingASR(mimi, lm, batch_size, asr_delay_in_tokens=self.delay,
                                mimi_dtype=md, sum_condition=cond, device=dev,
                                graphed=False)
        self.state = self.asr.init_state()
        self.batch_size = batch_size
        self.frames, self.ms = 0, []
        self.tokens = {b: [] for b in range(batch_size)}  # a slot's session's tokens

    def warmup(self):
        self.state = self.asr.warmup(self.mimi_params, self.lm_params, self.state)

    def step(self, pcm, flags, tokens, extra, updates):
        mask = np.zeros(self.batch_size, bool)
        for b, u in enumerate(updates):
            flags[b] = 0
            if u == RESET:
                self.state = self.asr.reset_batch_idx(self.state, b)
                self.tokens[b] = []
            elif u == ACTIVE:
                mask[b] = True
        if not mask.any():
            return
        t0 = time.perf_counter()
        _, self.state = self.asr.step_pcm(self.mimi_params, self.lm_params, self.state,
                                          pcm.reshape(self.batch_size, 1, -1), mask)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.frames += 1
        for b in np.nonzero(mask)[0]:
            item = self.asr.items[b]
            self.tokens[b].append(item.text_token)
            flags[b] = 1
            tokens[b] = item.text_token if item.step_idx >= self.delay else 0


def init(batch_size, config):
    return App(batch_size, config)
'''


def fleet_toml(name: str, disp_port: int) -> str:
    return f"""
[modules.chat]
type = "moshi"
route = "/api/chat"
checkpoint_dir = "{SERVE_DIR}"
vault_url = "http://127.0.0.1:{disp_port}"
fleet_auth = "{FLEET_AUTH}"
replicate_every = {FLEET_REPLICATE}
log_dir = "{FLEET_DIR / ('logs_' + name)}"

[modules.counts]
type = "py"
route = "/api/counts"
script = "{FLEET_DIR / 'counts.py'}"
"""


class FleetProc:
    """One process of the fleet (a worker or the dispatcher), its output in
    FLEET_DIR/<name>.log."""

    def __init__(self, name: str, args: list, port: int):
        self.name, self.port = name, port
        self.log_path = FLEET_DIR / f"{name}.log"
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT,
                                     stdout=self._log, stderr=subprocess.STDOUT)
        self.base = f"http://127.0.0.1:{port}"
        self.chat = f"ws://127.0.0.1:{port}/api/chat"

    def tail(self, n: int = 20) -> str:
        return "\n".join(self.log_path.read_text().splitlines()[-n:])

    def pushes(self, rid: str) -> tuple[set, dict]:
        """(the steps of `rid`'s vault pushes started, {step: (bytes, s, s of
        the stream to the vault)} of those finished), from the worker's
        log."""
        text = self.log_path.read_text()
        started = {int(s) for s in re.findall(rf"vault push {rid}: step (\d+) started", text)}
        done = {int(s): (int(b), float(t), float(v)) for s, b, t, v in re.findall(
            rf"vault push {rid}: step (\d+), (\d+) bytes in ([0-9.]+) s \(([0-9.]+) s to the "
            rf"vault\)", text)}
        failed = re.findall(rf"vault push {rid} failed: (.*)", text)
        if failed:
            raise RuntimeError(f"fleet {self.name}: a vault push failed: {failed[0]}")
        return started, done

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._log.close()


async def fleet_up(http, p: FleetProc, path: str):
    """Wait until `p` answers on `path`."""
    import aiohttp
    t0 = time.perf_counter()
    while True:
        if p.proc.poll() is not None:
            raise RuntimeError(f"fleet: {p.name} exited {p.proc.returncode}:\n{p.tail()}")
        try:
            async with http.get(p.base + path, timeout=aiohttp.ClientTimeout(total=2)) as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except (aiohttp.ClientError, asyncio.TimeoutError):
            pass
        if time.perf_counter() - t0 > FLEET_START_TIMEOUT:
            raise RuntimeError(f"fleet: {p.name} did not come up:\n{p.tail()}")
        await asyncio.sleep(0.25)


async def open_chat(http, url: str, query: dict) -> tuple:
    """A /api/chat session: (socket, the config echo or None)."""
    from moshi_tpu_torch.serve import protocol as proto
    ws = await http.ws_connect(url, params=query)
    if (first := await ws.receive_bytes(timeout=SERVE_TIMEOUT)) != proto.handshake():
        raise RuntimeError(f"fleet: handshake {first!r}")
    echo = (json.loads((await ws.receive_bytes(timeout=SERVE_TIMEOUT))[1:]) if query else None)
    return ws, echo


async def new_log(p: FleetProc, before: set) -> np.ndarray:
    """The token rows [T, 1 + dep_q] of the session log `p` writes next."""
    from moshi_tpu_torch.utils.safetensors import load_file
    d = FLEET_DIR / f"logs_{p.name}"
    t0 = time.perf_counter()
    while not (new := set(d.glob("*.safetensors")) - before):
        if time.perf_counter() - t0 > SERVE_TIMEOUT:
            raise RuntimeError(f"fleet: {p.name} wrote no session log")
        await asyncio.sleep(0.05)
    await asyncio.sleep(0.2)  # written whole
    t = load_file(new.pop())
    if t["text_tokens"].dtype != torch.int32:
        raise RuntimeError("fleet: a session log's tokens are not int32")
    return np.concatenate([t["text_tokens"].numpy()[:, None], t["audio_tokens"].numpy().T], 1)


def logs_of(p: FleetProc) -> set:
    return set((FLEET_DIR / f"logs_{p.name}").glob("*.safetensors"))


async def counts_of(http, p: FleetProc) -> dict:
    async with http.get(p.base + "/api/counts") as r:
        return await r.json()


async def migrate(http, first: FleetProc, second: FleetProc, query: dict, pcm, disp=None) -> dict:
    """A session with a resume id on `first` for FLEET_KILL frames after the
    skipped one, live replication on; once its pushes have landed, `first`
    is killed (no disconnect snapshot); through the dispatcher `disp`
    (when given) the client takes a new ticket, and resumes on `second`
    from the vault's step for the rest of `pcm`."""
    async def ticket():
        t = await (await http.get(f"{disp.base}/add_user", params={"queue_id": "smoke"})).json()
        return await (await http.get(f"{disp.base}/check_user", params={
            "session_id": str(t["session_id"]), "session_auth_id": t["session_auth_id"]})).json()

    out = {}
    if disp is not None:
        c = await ticket()
        if c["status"] != "ready" or c["worker_addr"] != first.chat:
            raise RuntimeError(f"fleet: the dispatcher handed out {c}, not {first.name}")
    ws, echo = await open_chat(http, first.chat, {"resume_support": "1", **query})
    rid = echo["resume_id"]
    out["first"], out["first_ms"] = await frames_session(ws, pcm[:1 + FLEET_KILL])
    t0 = time.perf_counter()
    while True:  # every push started has landed in the vault
        started, done = first.pushes(rid)
        if started and started <= set(done):
            break
        if time.perf_counter() - t0 > SERVE_TIMEOUT:
            raise RuntimeError(f"fleet: {first.name}'s pushes {started} never landed ({done})")
        await asyncio.sleep(0.05)
    out["pushes"], out["resume_step"] = done, max(done)
    out["first_counts"] = await counts_of(http, first)
    first.kill()
    try:
        await asyncio.wait_for(ws.close(), 5)
    except Exception:
        pass  # the worker is gone
    if disp is not None:
        t0 = time.perf_counter()
        while True:  # the dispatcher's poll has seen the worker go
            stats = await (await http.get(f"{disp.base}/stats")).json()
            if not next(w for w in stats["workers"] if w["addr"] == first.chat)["reachable"]:
                break
            if time.perf_counter() - t0 > SERVE_TIMEOUT:
                raise RuntimeError(f"fleet: the dispatcher never saw {first.name} die")
            await asyncio.sleep(0.05)
        c = await ticket()
        if c["status"] != "ready" or c["worker_addr"] != second.chat:
            raise RuntimeError(f"fleet: the re-queued client was handed {c}, not {second.name}")
    before = logs_of(second)
    t0 = time.perf_counter()
    ws, echo = await open_chat(http, second.chat, {"resume_support": "1", "resume": rid})
    out["resume_s"] = time.perf_counter() - t0
    if echo.get("resumed") is not True:
        raise RuntimeError(f"fleet: {second.name} did not resume the session: {echo}")
    out["second"], _ = await frames_session(ws, pcm[1 + out["resume_step"]:])
    await ws.close()
    out["second_tokens"] = await new_log(second, before)
    return out


async def reference_session(http, p: FleetProc, query: dict, pcm) -> dict:
    """An unbroken session on `p` over all of `pcm`, no resume id (so no
    replication): its replies per frame and its token log."""
    before = logs_of(p)
    ws, _ = await open_chat(http, p.chat, query)
    replies, _ = await frames_session(ws, pcm)
    await ws.close()
    return {"replies": replies, "tokens": await new_log(p, before)}


def fleet_pcm(frame_size: int) -> np.ndarray:
    return (0.3 * np.random.RandomState(SEED + 70).randn(1 + FLEET_FRAMES, frame_size)
            ).astype(np.float32)


async def drive_fleet(procs: dict, disp: FleetProc, frame_size: int, delay: int) -> dict:
    """(a) of [fleet]: the references and the two migrations."""
    import aiohttp
    a, b, c = procs["a"], procs["b"], procs["c"]
    pcm = fleet_pcm(frame_size)
    out = {}
    async with aiohttp.ClientSession() as http:
        ups = await asyncio.gather(*(fleet_up(http, p, "/api/counts")
                                     for p in procs.values()), fleet_up(http, disp, "/stats"))
        out["up_s"] = max(ups)
        out["build"] = {n: await counts_of(http, p) for n, p in procs.items()}
        out["ref"] = {"greedy": await reference_session(http, b, {}, pcm),
                      "sampled": await reference_session(http, b, FLEET_SAMPLED, pcm)}
        # C's first session of the sampled override set warms and captures
        # its step: here, before the measured runs
        ws, _ = await open_chat(http, c.chat, FLEET_SAMPLED)
        await frames_session(ws, pcm[:2])
        await ws.close()
        out["base"] = {n: await counts_of(http, p) for n, p in procs.items()}
        out["greedy"] = await migrate(http, a, b, {}, pcm, disp)
        out["sampled"] = await migrate(http, c, b, FLEET_SAMPLED, pcm)
        out["end_b"] = await counts_of(http, b)
    out["delay"] = delay
    return out


def check_migration(run: dict, ref: dict, delay: int, what: str) -> dict:
    """A migrated session against the unbroken one: the first worker's
    replies to frames 0..FLEET_KILL and the second's from the resumed step
    on, byte for byte (PCM and text), and the second's session log from
    that step on, token for token."""
    s = run["resume_step"]
    if run["first"] != ref["replies"][:1 + FLEET_KILL]:
        raise RuntimeError(f"fleet {what}: the first worker's replies differ from the "
                           f"unbroken session's")
    if run["second"] != ref["replies"][1 + s:]:
        i = next(i for i, (x, y) in enumerate(zip(run["second"], ref["replies"][1 + s:]))
                 if x != y)
        raise RuntimeError(f"fleet {what}: the resumed session differs from the unbroken one "
                           f"at frame {1 + s + i}")
    want = ref["tokens"][s - delay:]
    if not np.array_equal(run["second_tokens"], want):
        raise RuntimeError(f"fleet {what}: the resumed tokens differ from the unbroken ones")
    pcm_frames = sum(any(m[0] == 10 for m in r) for r in run["second"])
    return {"resume_step": s, "frames_compared": FLEET_FRAMES - s, "pcm_frames": pcm_frames,
            "token_rows": len(want)}


def run_fleet_migration(dev, card: str) -> dict:
    """(a): the dispatcher and three workers as subprocesses on the card."""
    from moshi_tpu_torch.models.loaders import CheckpointInfo, _lm_config, mimi_config_from_dict
    from moshi_tpu_torch.models.mimi import MimiModel

    info = CheckpointInfo.from_dir(SERVE_DIR)
    cfg = _lm_config(info.lm_config)
    mimi_cfg = (json.loads((SERVE_DIR / info.mimi_config_name).read_text())
                if info.mimi_config_name else None)
    frame_size = MimiModel(mimi_config_from_dict(mimi_cfg, info.num_mimi_codebooks())).frame_size
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    FLEET_DIR.mkdir(parents=True)
    (FLEET_DIR / "counts.py").write_text(COUNTS_SCRIPT)
    disp_port = free_port()
    ports = {n: free_port() for n in "abc"}
    procs, disp = {}, None
    t0 = time.perf_counter()
    try:
        disp = FleetProc("dispatcher", [
            "moshi_tpu_torch.serve.dispatcher", "--host", "127.0.0.1", "--port", str(disp_port),
            "--worker", f"ws://127.0.0.1:{ports['a']}/api/chat=1",
            "--worker", f"ws://127.0.0.1:{ports['b']}/api/chat=1",
            "--poll", "0.2", "--fleet-auth", FLEET_AUTH], disp_port)
        for n, port in ports.items():
            (FLEET_DIR / f"{n}.toml").write_text(fleet_toml(n, disp_port))
            procs[n] = FleetProc(n, ["moshi_tpu_torch.serve.worker", "--config",
                                     str(FLEET_DIR / f"{n}.toml"), "--host", "127.0.0.1",
                                     "--port", str(port), "--device", FLEET_DEVICE], port)
        out = asyncio.run(drive_fleet(procs, disp, frame_size, cfg.max_delay))
    finally:
        for p in list(procs.values()) + ([disp] if disp else []):
            p.kill()
    out["phase_s"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------ fleet (b)
def build_vision(dev):
    """lm_config_v0_1_vision (VISION_LAYERS deep) from a seed, q4 temporal
    linears, text head and cross projections, int8 depformer, and a bf16
    Mimi v0.1."""
    from dataclasses import replace
    from moshi_tpu_torch.models.lm import LMModel, lm_config_v0_1_vision
    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config
    from moshi_tpu_torch.utils.quantize import QTensor4, quantize_lm_params

    t0 = time.perf_counter()
    cfg = lm_config_v0_1_vision()
    if VISION_LAYERS != cfg.num_layers:
        cfg = replace(cfg, num_layers=VISION_LAYERS)
    lm = LMModel(cfg)
    g = torch.Generator(device=dev).manual_seed(SEED + 80)
    params = quantize_lm_params(lm.init_params(g, torch.bfloat16, dev), mode="int4")
    free_memory()
    shared = params["transformer"]["cross_attn_shared"]
    if not all(isinstance(shared[k], QTensor4) for k in ("q_proj", "kv_proj", "out_proj")):
        raise RuntimeError("fleet vision: the cross projections are not q4")
    mimi = MimiModel(mimi_v0_1_config(cfg.dep_q))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    torch.cuda.synchronize()
    return lm, params, mimi, mimi_params, time.perf_counter() - t0


def vision_session(state, payloads) -> tuple[list, list]:
    """The payloads through the session loop in-process: (the messages
    sent, the state's cross K/V tensors right after each MT 8 was taken)."""
    from moshi_tpu_torch.serve import protocol as proto
    sent, seen = [], []

    async def messages():
        for p in payloads:
            yield p
            if p[0] == proto.MT_IMAGE:  # taken once the loop asks for the next one
                tr = state.gen_state["transformer"]
                seen.append((tr["k_cross"], tr["k_cross"].data_ptr()))

    async def send(b):
        sent.append(b)

    asyncio.run(state.run_session({}, messages(), send))
    return sent, seen


def run_vision(dev, card: str, moshi_step: dict) -> dict:
    """(b): MT 8 on ServerState over the vision preset, graphed against
    eager: 10 frames, an image, 20 frames, a second image of the same size,
    10 frames."""
    import struct
    from moshi_tpu_torch.serve import protocol as proto
    from moshi_tpu_torch.serve.server import ServerState
    from moshi_tpu_torch.utils.safetensors import load_file

    lm, params, mimi, mimi_params, build_s = build_vision(dev)
    cfg = lm.config
    kv_dim = cfg.cross_attention_kv_dim or cfg.dim
    rs = np.random.RandomState(SEED + 81)
    pcm = (0.3 * rs.randn(1 + sum(VISION_FRAMES), mimi.frame_size)).astype(np.float32)
    images = [(0.5 * rs.randn(VISION_IMAGE, kv_dim)).astype(np.float32) for _ in range(2)]
    image_msgs = [proto.msg(proto.MT_IMAGE, struct.pack("<II", *im.shape) + im.tobytes())
                  for im in images]
    n0, n1, n2 = VISION_FRAMES
    payloads = ([proto.msg(proto.MT_METADATA, json.dumps({"raw_pcm": True}).encode())]
                + [proto.msg(proto.MT_PCM, f.tobytes()) for f in pcm[:1 + n0]] + [image_msgs[0]]
                + [proto.msg(proto.MT_PCM, f.tobytes()) for f in pcm[1 + n0:1 + n0 + n1]]
                + [image_msgs[1]]
                + [proto.msg(proto.MT_PCM, f.tobytes()) for f in pcm[1 + n0 + n1:]]
                + [proto.msg(proto.MT_PING)])
    out = {}
    for graphed in (True, False):
        log_dir = FLEET_DIR / f"vision_{'graphed' if graphed else 'eager'}"
        state = ServerState(mimi, mimi_params, lm, params, device=dev, graphed=graphed,
                            use_sampling=False, log_dir=str(log_dir))
        zero_counts()
        state.warmup()
        state.capture()
        built = read_counts()
        t0 = time.perf_counter()
        sent, seen = vision_session(state, payloads)
        seconds = time.perf_counter() - t0
        launched = {k: v - built[k] for k, v in read_counts().items()}
        tr = state.gen_state["transformer"]
        src = torch.from_numpy(images[1]).to(dev)[None]
        eager_rows = lm.transformer.precompute_cross(params["transformer"], src,
                                                     params["text_emb"]["weight"].dtype)
        rows_equal = all(torch.equal(tr[k], eager_rows[k]) for k in ("k_cross", "v_cross"))
        logs = list(log_dir.glob("*.safetensors"))
        t = load_file(logs[0])
        out[graphed] = {"sent": sent, "built": built, "launched": launched, "s": seconds,
                        "rows_equal": rows_equal, "in_place": (seen[0][0] is seen[1][0]
                                                               and seen[0][1] == seen[1][1]),
                        "tokens": np.concatenate([t["text_tokens"].numpy()[:, None],
                                                  t["audio_tokens"].numpy().T], 1),
                        "cross_replays": state._gens[()].step_cross.replays}
        del state, tr, eager_rows
        free_memory()
    g, e = out[True], out[False]
    ack = proto.msg(proto.MT_METADATA, json.dumps({"image": "ok", "frames": VISION_IMAGE}
                                                  ).encode())
    if [m for m in g["sent"] if m[0] == proto.MT_METADATA][-2:] != [ack, ack]:
        raise RuntimeError("fleet vision: an image was not acknowledged")
    if g["sent"] != e["sent"] or not np.array_equal(g["tokens"], e["tokens"]):
        raise RuntimeError("fleet vision: the graphed session differs from the eager one")
    if not (g["rows_equal"] and e["rows_equal"] and g["in_place"] and e["in_place"]):
        raise RuntimeError(f"fleet vision: cross K/V rows equal {g['rows_equal']} / "
                           f"{e['rows_equal']}, in place {g['in_place']} / {e['in_place']}")
    check_tokens(g["tokens"], cfg, "fleet vision")
    # eager: every frame launches; per step without the cross block (n0
    # steps) and with it (n1 + n2 steps)
    per_cross = {}
    for k in TPU_KERNELS:
        rest = e["launched"][k] - n0 * moshi_step[k]
        per_cross[k], odd = divmod(rest, n1 + n2)
        if odd:
            raise RuntimeError(f"fleet vision: {k} launched {e['launched'][k]} eagerly, not "
                               f"{n0} x {moshi_step[k]} + {n1 + n2} x a cross step")
    # graphed: the build's warm-up frames and captures, then the cross
    # step's one capture, at the first frame after the first image
    warm = max(4, cfg.max_delay + 2)
    want_built = {k: (warm + 1) * moshi_step[k] + per_cross[k] for k in TPU_KERNELS}
    if g["built"] != want_built or g["launched"] != per_cross:
        raise RuntimeError(f"fleet vision: graphed launches {g['built']} + {g['launched']}, "
                           f"expected {want_built} + {per_cross}")
    generated = len(g["tokens"])
    phase("fleet", f"(b) vision: lm_config_v0_1_vision {cfg.num_layers} layers of {cfg.dim} "
          f"(q4 temporal and cross projections, int8 depformer) + bf16 Mimi from seed in "
          f"{build_s:.1f} s; MT 8 in-process: {n0} frames, an image of {VISION_IMAGE} x "
          f"{kv_dim} seeded embeddings, {n1} frames, a second image, {n2} frames: both acked "
          f"{{\"image\": \"ok\", \"frames\": {VISION_IMAGE}}}; graphed = eager in every "
          f"message and {generated} token frames; the second image's cross K/V written into "
          f"the first one's tensors (the cross step captured once, {g['cross_replays']} "
          f"replays), equal to precompute_cross's eager rows; a step launches "
          f"{ {k: v for k, v in moshi_step.items() if v} } without the cross block, "
          f"{ {k: v for k, v in per_cross.items() if v} } with it; session {g['s']:.2f} s "
          f"graphed, {e['s']:.2f} s eager ({card})")
    launches = {k: g["built"][k] + g["launched"][k] for k in TPU_KERNELS}
    return {"layers": cfg.num_layers, "build_s": build_s, "per_cross_step": per_cross,
            "graphed_s": g["s"], "eager_s": e["s"], "token_frames": generated,
            "launches": launches}


# ------------------------------------------------------------ fleet (c)
def py_basr_toml(dev, tokenizer) -> str:
    knobs = (f'asr_delay_in_tokens = {ASR_DELAY}\nconditioning_delay = {ASR_COND["delay"]}\n'
             f'kv_cache = "int8"\nmimi_dtype = "bf16"\n')
    return f"""
[modules.pyasr]
type = "py_batched_asr"
route = "/api/py-asr"
script = "{FLEET_DIR / 'py_basr_app.py'}"
batch_size = {PY_BASR_SLOTS}
asr_delay_in_tokens = {ASR_DELAY}
text_tokenizer_file = "{tokenizer}"

[modules.pyasr.config]
checkpoint_dir = "{ASR_DIR}"
device = "{torch.device(dev).type}"
{knobs}
[modules.asr]
type = "batched_asr"
route = "/api/asr-streaming"
checkpoint_dir = "{ASR_DIR}"
batch_size = {PY_BASR_SLOTS}
{knobs}"""


async def basr_client(http, url: str, slots: dict, state):
    """A socket on the ASR route, its Ready read; the slot it took is
    appended to slots[url]."""
    from moshi_tpu_torch.serve.msgpack_codec import unpackb
    before = set(state.slot_queues)
    ws = await http.ws_connect(url)
    if unpackb(await ws.receive_bytes(timeout=WORKER_TIMEOUT)).get("type") != "Ready":
        raise RuntimeError("fleet py_basr: no Ready")
    slots[url].append((set(state.slot_queues) - before).pop())
    return ws


async def basr_stream(ws, frames, done) -> list:
    """The frames, a Marker and PY_BASR_TAIL silent frames as fast as the
    socket takes them; every message until the Marker's echo, `done()`
    (every frame stepped) and 0.5 s after."""
    from moshi_tpu_torch.serve.msgpack_codec import packb, unpackb
    out = []

    async def read():
        while True:
            out.append(unpackb(await ws.receive_bytes(timeout=WORKER_TIMEOUT)))

    reader = asyncio.ensure_future(read())
    silence = np.zeros_like(frames[0])
    for f in frames:
        await ws.send_bytes(packb({"type": "Audio", "pcm": f.tolist()}))
    await ws.send_bytes(packb({"type": "Marker", "id": 1}))
    for _ in range(PY_BASR_TAIL):
        await ws.send_bytes(packb({"type": "Audio", "pcm": silence.tolist()}))
    t0 = time.perf_counter()
    while not (any(m["type"] == "Marker" for m in out) and done()):
        if reader.done():
            reader.result()
        if time.perf_counter() - t0 > WORKER_TIMEOUT:
            raise RuntimeError("fleet py_basr: the Marker did not come back, or a frame was "
                               "not stepped")
        await asyncio.sleep(0.01)
    await asyncio.sleep(0.5)
    reader.cancel()
    await ws.close()
    return out


def run_py_basr(dev, card: str) -> dict:
    """(c): a worker of a py_batched_asr module (PY_BASR_SCRIPT over
    StreamingASR, eager) beside a batched_asr one over [asr]'s checkpoint,
    both at B = PY_BASR_SLOTS; PY_BASR_CLIENTS socket clients each, the
    same seeded PCM to both."""
    import tomllib
    import aiohttp
    from aiohttp import web
    from moshi_tpu_torch.models.loaders import CheckpointInfo
    from moshi_tpu_torch.serve.worker import build_app

    (FLEET_DIR / "py_basr_app.py").write_text(PY_BASR_SCRIPT)
    tokenizer = CheckpointInfo.from_dir(ASR_DIR).tokenizer_path
    zero_counts()
    t0 = time.perf_counter()
    app = build_app(tomllib.loads(py_basr_toml(dev, tokenizer)), device=dev)
    build_s = time.perf_counter() - t0
    built = read_counts()
    pstate, bstate = app["modules"]["pyasr"]["state"], app["modules"]["asr"]["state"]
    papp = pstate.app
    # the batched engine's text token of each executing slot, each frame
    btokens = {b: [] for b in range(PY_BASR_SLOTS)}
    step_pcm = bstate.asr.step_pcm

    def recorded(mimi_params, lm_params, state, pcm, exec_mask=None):
        out = step_pcm(mimi_params, lm_params, state, pcm, exec_mask)
        mask = np.ones(PY_BASR_SLOTS, bool) if exec_mask is None else np.asarray(exec_mask)
        for b in np.nonzero(mask)[0]:
            btokens[int(b)].append(bstate.asr.items[b].text_token)
        return out

    bstate.asr.step_pcm = recorded
    layers = bstate.asr.lm.config.num_layers
    # unit-RMS noise (a quiet random Mimi maps noise to one code)
    pcm = np.random.RandomState(SEED + 90).randn(
        PY_BASR_CLIENTS, PY_BASR_FRAMES, bstate.frame_size).astype(np.float32)

    async def drive():
        runner = web.AppRunner(app)
        await runner.setup()
        port = free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        urls = {"py": f"ws://127.0.0.1:{port}/api/py-asr",
                "batched": f"ws://127.0.0.1:{port}/api/asr-streaming"}
        slots = {u: [] for u in urls.values()}
        try:
            async with aiohttp.ClientSession() as http:
                socks = {k: [await basr_client(http, u, slots,
                                               pstate if k == "py" else bstate)
                             for _ in range(PY_BASR_CLIENTS)] for k, u in urls.items()}
                zero_counts()
                for b in btokens:
                    btokens[b].clear()
                n = PY_BASR_FRAMES + PY_BASR_TAIL
                stepped = {"py": lambda b: len(papp.tokens[b]) >= n,
                           "batched": lambda b: len(btokens[b]) >= n}
                got = await asyncio.gather(*(
                    basr_stream(ws, pcm[i], lambda k=k, b=slots[urls[k]][i]: stepped[k](b))
                    for k in urls for i, ws in enumerate(socks[k])))
                # the py loop's last frame, still on its thread, lands
                last, t0 = -1, time.perf_counter()
                while pstate.step_idx != last or time.perf_counter() - t0 < 0.5:
                    if pstate.step_idx != last:
                        last, t0 = pstate.step_idx, time.perf_counter()
                    await asyncio.sleep(0.05)
                served, py_frames = read_counts(), papp.frames
        finally:
            await runner.cleanup()
        return ({k: got[j * PY_BASR_CLIENTS:(j + 1) * PY_BASR_CLIENTS]
                 for j, k in enumerate(urls)},
                {k: slots[u] for k, u in urls.items()}, served, py_frames)

    try:
        msgs, slots, served, py_frames = asyncio.run(drive())
    finally:
        bstate.asr.step_pcm = step_pcm
    want = {k: layers * py_frames if k == "decode_attention_int8" else 0 for k in TPU_KERNELS}
    if served != want:
        raise RuntimeError(f"fleet py_basr: serving launched {served}, expected {want} "
                           f"({layers} a frame of the py app's {py_frames}, none of the "
                           f"captured batched_asr)")
    want_built = {k: layers * (3 + 4) if k == "decode_attention_int8" else 0
                  for k in TPU_KERNELS}
    if built != want_built:
        raise RuntimeError(f"fleet py_basr: the build launched {built}, expected {want_built} "
                           f"(the py app's 3 eager warm-up frames, batched_asr's 3 + a "
                           f"capture)")
    findings, equal_tokens, equal_words = [], 0, 0
    n = PY_BASR_FRAMES + PY_BASR_TAIL
    for i in range(PY_BASR_CLIENTS):
        pt = papp.tokens[slots["py"][i]]
        bt = btokens[slots["batched"][i]]
        if len(pt) != n or len(bt) != n:
            raise RuntimeError(f"fleet py_basr: client {i} ran {len(pt)} / {len(bt)} frames")
        pw = [m["text"] for m in msgs["py"][i] if m["type"] == "Word"]
        bw = [m["text"] for m in msgs["batched"][i] if m["type"] == "Word"]
        if pt == bt:
            equal_tokens += 1
        else:
            first = next(f for f, (x, y) in enumerate(zip(pt, bt)) if x != y)
            findings.append(f"client {i}: tokens differ from frame {first}")
        if pw == bw:
            equal_words += 1
        else:
            findings.append(f"client {i}: words {pw[:4]} vs {bw[:4]}")
    said = {k: sum(m["type"] == "Word" for c in msgs[k] for m in c) for k in msgs}
    if not said["batched"] or not said["py"]:
        raise RuntimeError(f"fleet py_basr: Words from py_basr / batched_asr: {said}")
    pt50 = float(np.percentile(papp.ms, 50))
    bt50 = float(np.percentile(list(bstate.frame_times), 50))
    first_word = {k: next((f"{m['start_time']:.2f} s" for c in msgs[k] for m in c
                           if m["type"] == "Word"), "none") for k in msgs}
    phase("fleet", f"(c) py_batched_asr (a script over StreamingASR, eager) beside batched_asr "
          f"(graphed), both B = {PY_BASR_SLOTS} over [asr]'s checkpoint, int8 KV; "
          f"{PY_BASR_CLIENTS} socket clients each, {PY_BASR_FRAMES} seeded frames, a Marker, "
          f"{PY_BASR_TAIL} silent ones: text tokens equal for {equal_tokens} of "
          f"{PY_BASR_CLIENTS} clients over {n} frames, words equal for {equal_words} "
          f"({said['py']} py_basr Words, {said['batched']} batched_asr's, by client "
          f"{[sum(m['type'] == 'Word' for m in c) for c in msgs['py']]}); "
          f"{'; '.join(findings) or 'no difference'}; the first "
          f"word's start_time py_basr {first_word['py']} (its own frame clock) vs batched_asr "
          f"{first_word['batched']}; "
          f"decode_attention_int8 {served.get('decode_attention_int8')} launches = {layers} x "
          f"{py_frames} py frames, none from the captured engine; py frame p50 "
          f"{pt50:.2f} ms eager, batched_asr p50 {bt50:.2f} ms graphed; build_app "
          f"{build_s:.2f} s ({card})")
    del app, pstate, bstate, papp
    return {"build_s": build_s, "equal_tokens": equal_tokens, "equal_words": equal_words,
            "clients": PY_BASR_CLIENTS, "frames": n, "findings": findings,
            "py_frames": py_frames, "py_p50_ms": pt50,
            "batched_p50_ms": bt50, "per_frame": {k: (layers if k == "decode_attention_int8"
                                                     else 0) for k in TPU_KERNELS},
            "launches": {k: built[k] + served[k] for k in TPU_KERNELS}}


# --------------------------------------------------------- fleet, whole
def run_fleet(dev, card: str, serve: dict, worker: dict) -> dict:
    """[fleet]: (a) migration through the dispatcher's vault across worker
    subprocesses, (b) MT 8 on the vision preset, (c) py_batched_asr."""
    t0 = time.perf_counter()
    moshi_step = worker["per_frame"]["chat"]
    mig = run_fleet_migration(dev, card)
    delay = mig["delay"]
    chat_frames = max(4, delay + 2) + 1
    for n, got in mig["build"].items():
        if got != {k: moshi_step[k] * chat_frames for k in got}:
            raise RuntimeError(f"fleet: worker {n}'s build launched {got}")
    override = {k: 3 * moshi_step[k] for k in moshi_step}
    for n in "bc":  # the sampled override set: 2 warm-up steps and its capture
        if mig["base"][n] != {k: mig["build"][n][k] + override[k] for k in override}:
            raise RuntimeError(f"fleet: worker {n} launched {mig['base'][n]} before the runs")
    for what, got, want in (("a at its kill", mig["greedy"]["first_counts"], mig["base"]["a"]),
                            ("c at its kill", mig["sampled"]["first_counts"], mig["base"]["c"]),
                            ("b at the end", mig["end_b"], mig["base"]["b"])):
        if got != want:
            raise RuntimeError(f"fleet: worker {what} launched {got}, {want} before the "
                               f"migrations: kernels outside the graphs while serving")
    res = {}
    for kind in ("greedy", "sampled"):
        res[kind] = check_migration(mig[kind], mig["ref"][kind], delay, kind)
        check_tokens(mig[kind]["second_tokens"], _fleet_cfg(), f"fleet {kind}")
    if mig["ref"]["greedy"]["replies"] == mig["ref"]["sampled"]["replies"]:
        raise RuntimeError("fleet: the sampled session equals the greedy one")
    ms = [m for m in mig["greedy"]["first_ms"] if m is not None]
    worst = int(np.argmax(ms))
    p50, p90 = (float(np.percentile(ms, p)) for p in (50, 90))
    pushes = {k: mig[k]["pushes"] for k in ("greedy", "sampled")}
    nbytes = max(b for p in pushes.values() for b, _, _ in p.values())
    push_s = [s for p in pushes.values() for _, s, _ in p.values()]
    send_s = [v for p in pushes.values() for _, _, v in p.values()]
    used = {k: v for k, v in moshi_step.items() if v}
    phase("fleet", f"(a) the dispatcher and workers a, b, c (moshi + a launch-count py "
          f"module, replicate_every {FLEET_REPLICATE}, vault on the dispatcher) as "
          f"subprocesses on the one card, up in {mig['up_s']:.1f} s; greedy: the client's "
          f"ticket went to a, {FLEET_KILL} frames, a SIGKILLed after its pushes of steps "
          f"{sorted(pushes['greedy'])} landed; the re-queued ticket went to b, which pulled "
          f"step {res['greedy']['resume_step']} from the vault in {mig['greedy']['resume_s']:.2f}"
          f" s and streamed to frame {FLEET_FRAMES}: replies byte for byte and "
          f"{res['greedy']['token_rows']} token rows equal an unbroken session on b; sampled "
          f"({FLEET_SAMPLED}): c killed after steps {sorted(pushes['sampled'])}, resumed on b "
          f"from step {res['sampled']['resume_step']}, its draws equal the unbroken sampled "
          f"session's")
    phase("fleet", f"(a) launches per captured step {used}; a worker's build {chat_frames} x "
          f"that, the sampled override set 3 x at its first session on b and c, none while "
          f"the migrated sessions ran (a, c at their kill, b at the end)")
    phase("fleet", f"(a) on a with replication on: frame sent -> PCM reply p50 {p50:.2f} ms, "
          f"p90 {p90:.2f} ms, worst {ms[worst]:.2f} ms (step {worst + 1 + delay}; "
          f"[serve] p50 {serve['p50_ms']:.2f} ms in this run); a snapshot {nbytes} bytes, "
          f"pushes {[round(s, 3) for s in push_s]} s, of which the stream into the vault "
          f"{[round(s, 3) for s in send_s]} s; the resumes' pulls and restores "
          f"{[round(mig[k]['resume_s'], 2) for k in ('greedy', 'sampled')]} s ({card})")
    mig_s = mig["phase_s"]
    free_memory()
    zero_counts()
    vision = run_vision(dev, card, moshi_step)
    free_memory()
    basr = run_py_basr(dev, card)
    free_memory()
    seconds = time.perf_counter() - t0
    phase("fleet", f"the phase took {seconds:.1f} s ((a) {mig_s:.1f} s)")
    workers = [mig["greedy"]["first_counts"], mig["sampled"]["first_counts"], mig["end_b"]]
    launches = {k: sum(w[k] for w in workers) + vision["launches"][k] for k in TPU_KERNELS}
    return {"launches": launches, "per_step": moshi_step, "vision_per_step": vision[
                "per_cross_step"], "py_basr": basr,
            "vision": {k: v for k, v in vision.items() if k != "launches"},
            "migration": {"up_s": mig["up_s"], "p50_ms": p50, "p90_ms": p90,
                          "worst_ms": ms[worst], "worst_step": worst + 1 + delay,
                          "frame_ms": [round(m, 2) for m in ms],
                          "serve_p50_ms": serve["p50_ms"], "snapshot_bytes": nbytes,
                          "push_s": push_s, "push_send_s": send_s, **{k: res[k] for k in res},
                          "resume_s": [mig[k]["resume_s"] for k in ("greedy", "sampled")],
                          "phase_s": mig_s},
            "phase_s": seconds}


def _fleet_cfg():
    from moshi_tpu_torch.models.lm import lm_config_v0_1
    return lm_config_v0_1()


# -------------------------------------------------------------------- tts
class TtsTokenizer:
    """The JAX benchmark's host tokenizer stub (moshi_tpu/benchmark.py:352-354):
    one token per word."""

    def encode(self, word):
        return [7 + (len(word) % 13)]


def build_tts(dev):
    """tts_v0_1 at full width from a seed on the card: int8 weights on every
    linear the JAX package's `--weights int8` quantizes, the int4 KV cache
    at context TTS_CONTEXT, the bf16 Mimi v0.1 with 16 codebooks, a
    speaker_wavs tensor condition fused by cross and a `cfg` LUT condition
    fused by sum."""
    from moshi_tpu_torch.conditioners import (ConditionFuser, ConditionProvider,
                                              LUTConditioner, TensorConditioner)
    from moshi_tpu_torch.models.lm import LMModel, lm_config_tts_v0_1
    from moshi_tpu_torch.models.mimi import MimiModel, mimi_v0_1_config
    from moshi_tpu_torch.utils.quantize import quantize_lm_params
    from moshi_tpu_torch.utils.serving import override_lm

    t0 = time.perf_counter()
    lm = override_lm(LMModel(lm_config_tts_v0_1()), kv_cache="int4", context=TTS_CONTEXT)
    cfg = lm.config
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    lm_params = quantize_lm_params(lm.init_params(g, torch.bfloat16, dev), mode="int8")
    free_memory()
    mimi = MimiModel(mimi_v0_1_config(cfg.dep_q))
    mimi_params = mimi.init_params(g, torch.bfloat16, dev)
    provider = ConditionProvider({
        "speaker_wavs": TensorConditioner(output_dim=cfg.dim, dim=TTS_VOICE[1]),
        "cfg": LUTConditioner(output_dim=cfg.dim, **TTS_CFG)})
    cp_params = provider.init_params(g, torch.float32, dev)
    torch.cuda.synchronize()
    tc = cfg.transformer_config
    phase("tts", f"tts_v0_1 int8 (dim {cfg.dim}, {cfg.num_layers} layers, {cfg.num_heads} "
          f"heads x {tc.head_dim}, {cfg.kv_cache_dtype} KV at ctx {cfg.context}, text head "
          f"{cfg.text_out_card}, card {cfg.card}, depformer {cfg.dep_q} x "
          f"{cfg.depformer_num_layers} layers of {cfg.depformer_dim}) + Mimi bf16 with "
          f"{mimi.num_codebooks} codebooks built from seed {SEED + 11} in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          f"on the card")
    return {"lm": lm, "lm_params": lm_params, "mimi": mimi, "mimi_params": mimi_params,
            "provider": provider, "cp_params": cp_params,
            "fuser": ConditionFuser({"cross": ["speaker_wavs"], "sum": ["cfg"]})}


def tts_model(models, lm, temp: float):
    """TTSModel over `lm` and the models' Mimi and conditioners, the JAX
    benchmark's state machine and delays."""
    from moshi_tpu_torch.models.tts import StateMachine, TokenIds, TTSModel

    c = lm.config
    return TTSModel(lm, models["mimi"], TtsTokenizer(),
                    StateMachine(TokenIds(card=c.text_card + 1), max_padding=8,
                                 initial_padding=2),
                    delay_steps=TTS_DELAY_STEPS, condition_provider=models["provider"],
                    fuser=models["fuser"], max_speakers=TTS_MAX_SPEAKERS, temp=temp,
                    n_q=c.dep_q, max_gen_length=10_000, final_padding=4)


def tts_get_prefix(dev, models, card: str) -> dict:
    """TTSModel.get_prefix on TTS_PREFIX_SECONDS of seeded PCM through the
    TTS engine's Mimi (bf16, 16 codebooks): its audio rows must equal that
    Mimi's offline encode of the same PCM, its text row ZERO_TOKEN."""
    from moshi_tpu_torch.models.lm import ZERO_TOKEN

    mimi, params = models["mimi"], models["mimi_params"]
    tts = tts_model(models, models["lm"], 0.0)
    n_q = models["lm"].config.n_q
    wav = (0.1 * np.random.RandomState(SEED + 22).randn(
        TTS_PREFIX_SECONDS * mimi.config.sample_rate)).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefix = tts.get_prefix(params, wav)
    ms = (time.perf_counter() - t0) * 1e3
    codes = mimi.encode(params, torch.from_numpy(wav).to(dev, torch.bfloat16)[None, None])
    ref = codes[0, :n_q, :-2].cpu().numpy()
    if not (prefix.shape == (1 + n_q, ref.shape[1]) and np.array_equal(prefix[1:], ref)
            and (prefix[0] == ZERO_TOKEN).all()):
        raise RuntimeError(f"get_prefix {prefix.shape} differs from Mimi's encode {ref.shape}")
    phase("tts", f"get_prefix of {TTS_PREFIX_SECONDS} s of PCM: {prefix.shape[1]} frames x "
          f"{n_q} codebooks + the ZERO_TOKEN text row, equal to Mimi's offline encode; "
          f"{ms:.2f} ms (the first call, from host PCM to host codes) ({card})")
    return {"ms": ms, "frames": int(prefix.shape[1])}


def tts_engine(dev, models, lm, temp: float, graphed: bool):
    """A warmed-up BatchedTTSState at B = TTS_SLOTS over `lm` (the models'
    weights), the JAX benchmark's state machine and delays."""
    from moshi_tpu_torch.serve.batched_tts import BatchedTTSState

    tts = tts_model(models, lm, temp)
    state = BatchedTTSState(tts, models["lm_params"], models["mimi_params"], TTS_SLOTS,
                            condition_params=models["cp_params"], voice_frames=TTS_VOICE[0],
                            device=dev, graphed=graphed, rng_seed=SEED)
    if state.graphed != graphed:
        raise RuntimeError(f"BatchedTTSState on the card: graphed {state.graphed}")
    state.warmup()
    torch.cuda.synchronize()
    return state


def tts_launches(cfg, params, batch: int) -> dict:
    """Kernel launches of one TTS frame at B = batch, by graph: "main" (graph
    1 with the cross block: each temporal linear per layer, the cross q and
    out projections per layer, the text head, and one K4 (int4 KV, each
    writing its layer's column) or K6 (int8 KV) per layer), "main_plain"
    (the same without the cross block, while no slot has a voice) and
    "depth" (graph 2: each depformer linear per layer and step,
    depformer_in and the audio head per step); each linear on the kernel
    qmatmul.route picks for bf16 x of `batch` rows (int8_route: one
    int8_wgmma launch above 16 rows, the heads in 16-row chunks); no q4."""
    from moshi_tpu_torch.utils.quantize import QTensor

    tl, dl = params["transformer"]["layers"], params["depformer"]["layers"]
    temporal = [tl["attn"]["in_proj"], tl["attn"]["out_proj"], tl["mlp"]["linear1"],
                tl["mlp"]["linear2"]]
    cross = [tl["cross_attn"]["q_proj"], tl["cross_attn"]["out_proj"]]
    dep = [dl["attn"]["in_proj"], dl["attn"]["out_proj"], dl["mlp"]["linear_in"],
           dl["mlp"]["linear_out"]]
    head = [(params["text_linear"]["weight"], 1)]
    graphs = {"main": [(w, cfg.num_layers) for w in temporal + cross] + head,
              "main_plain": [(w, cfg.num_layers) for w in temporal] + head,
              "depth": [(w, cfg.depformer_num_layers * cfg.dep_q) for w in dep]
              + [(params["depformer_in"]["weight"], cfg.dep_q),
                 (params["linears"]["weight"], cfg.dep_q)]}
    out, shapes = {}, {}
    for name, ws in graphs.items():
        per = dict.fromkeys(TPU_KERNELS, 0)
        for w, n in ws:
            if not isinstance(w, QTensor):
                raise RuntimeError("the tts tree is not int8 on every linear")
            din, dout = w.q.shape[-2:]
            kernel, launches = int8_route(batch, din, dout)
            per[kernel] += n * launches
            if name != "main_plain":
                shapes[(din, dout)] = shapes.get((din, dout), 0) + n
        if name != "depth":
            kv = cfg.kv_cache_dtype
            per["decode_attention_int4"] = per["cache_write_int4"] = (
                cfg.num_layers if kv == "int4" else 0)
            per["decode_attention_int8"] = cfg.num_layers if kv == "int8" else 0
        out[name] = per
    if shapes != TTS_INT8_SHAPES:
        raise RuntimeError(f"the TTS frame's linears {shapes} are not TTS_INT8_SHAPES")
    return out


def tts_words(n: int, salt: int) -> list[str]:
    """n words of a seeded vocabulary, different for each salt."""
    vocab = ("the quick brown fox jumps over a lazy dog while seven wizards quietly hex "
             "one jolly zebra near old stone bridges under bright winter skies").split()
    rs = np.random.RandomState(SEED + 100 + salt)
    return [vocab[i] for i in rs.randint(0, len(vocab), n)]


# the tts isolation run: slot -> (its session index, frames it executes in
# that session) of the copies of slot 0's session
TTS_SAME_AS_0 = {1: (0, TTS_FRAMES - 2), 2: (0, TTS_FRAMES - 7), 3: (0, TTS_FRAMES - 7),
                 4: (1, TTS_FRAMES - 22)}
TTS_ROLES = {"voiceless": 6, "voice_change": 5, "starved": 3, "starved_ticks": 5}


def tts_isolation_schedule():
    """serve_tts's script at B = TTS_SLOTS over TTS_FRAMES ticks: slot 6
    alone and voiceless on ticks 0-1 (the unconditioned mode), then slots 0
    and 1 with one script and voice A, slot 2 with them joining 5 ticks late,
    slot 3 with them starved of its last words for 5 ticks, slot 4 reset at
    tick 22 to them, slot 5 changing its voice at tick 20, slots 7.. with
    scripts and voices of their own."""
    rs = np.random.RandomState(SEED + 12)
    voice = [rs.randn(*TTS_VOICE).astype(np.float32) for _ in range(TTS_SLOTS + 2)]
    script = tts_words(12, 0)
    ref = [("join", voice[0]), ("words", [" ".join(script)]), "eos"]
    sched = [{} for _ in range(TTS_FRAMES)]
    sched[0] = {6: [("join", None), ("words", tts_words(12, 6))]}
    sched[2] = {0: ref, 1: ref,
                3: [("join", voice[0]), ("words", script[:2]),
                    ("refill", TTS_ROLES["starved_ticks"], script[2:], True)],
                4: [("join", voice[4]), ("words", tts_words(12, 4))],
                5: [("join", voice[5]), ("words", tts_words(12, 5))],
                **{s: [("join", voice[s]), ("words", tts_words(12, s))]
                   for s in range(7, TTS_SLOTS)}}
    sched[7] = {2: ref}
    sched[20] = {5: [("voice", voice[TTS_SLOTS])]}
    sched[22] = {4: ref}
    return sched


def tts_leaves(state) -> list:
    """Every tensor of a BatchedTTSState's streaming state: LMGen's (the
    caches, the cross K/V) and Mimi's decoder, and the summed condition."""
    return tensor_leaves([state.gen_state_cross, state.dec_state, state.cond_sum])


def check_tts_frames(tokens, cfg, what: str) -> None:
    """Output frames past the delays: text ids in [0, text_card], audio ids
    in [0, card) or the zero token of a codebook still within its delay."""
    gen = tokens[(tokens != -2).all(axis=1)]
    if not ((gen[:, 0] >= 0).all() and (gen[:, 0] <= cfg.text_card).all()
            and (gen[:, 1:] >= -1).all() and (gen[:, 1:] < cfg.card).all()):
        raise RuntimeError(f"{what}: token out of range")


def slowest_ticks(ms: list, n: int = 5) -> dict:
    """{tick: ms} of the n slowest ticks of a run."""
    return {int(i): round(ms[i], 2) for i in np.argsort(ms)[::-1][:n]}


def tts_greedy(dev, models, lm, what: str, profile: bool = False) -> tuple[dict, dict]:
    """The greedy isolation run of BatchedTTSState (tts_isolation_schedule),
    graphed (the main path: launch counts from the captures, replays), then
    eagerly (launches per frame), the two held equal in output frames, Text
    events, PCM and every state byte; the copies of slot 0's session must
    repeat it, the starved slot must sit out exactly its ticks.  With
    `profile`, then 5 frames of every slot on each engine and 5 graphed ones
    under the profiler.  Returns the graphed launches and a summary."""
    from moshi_tpu_torch.serve.batched_tts import serve_tts

    cfg = lm.config
    per = tts_launches(cfg, models["lm_params"], TTS_SLOTS)
    per_frame = {k: per["main"][k] + per["depth"][k] for k in per["main"]}
    schedule = tts_isolation_schedule()
    runs = {}
    for graphed in (True, False):
        state = tts_engine(dev, models, lm, 0.0, graphed)
        if graphed:
            kv = state.gen_state_cross["transformer"]
            phase("tts", f"{what}: B = {TTS_SLOTS}, {cfg.kv_cache_dtype} KV cache "
                  f"{tuple(kv['k'].shape)}, cross K/V {tuple(kv['k_cross'].shape)} "
                  f"{str(kv['k_cross'].dtype)[6:]} x 2; "
                  f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB on the card")
            del kv
        ptrs = [t.data_ptr() for t in tts_leaves(state)]
        zero_counts()
        sessions, ticks = serve_tts(state, schedule)
        launches = read_counts()
        if [t.data_ptr() for t in tts_leaves(state)] != ptrs:
            raise RuntimeError(f"{what}: a reset or a voice change moved a state tensor")
        runs["graphed" if graphed else "eager"] = (state, sessions, ticks, launches)
    state, sessions, ticks, launches = runs["graphed"]
    eager, e_sessions, e_ticks, e_launches = runs["eager"]
    n = len(ticks)
    replays = {"main_unconditioned": state.main[False].replays,
               "main_conditioned": state.main[True].replays, "depth": state.depth.replays}
    if n != TTS_FRAMES or replays != {"main_unconditioned": 2, "main_conditioned": n - 2,
                                      "depth": n}:
        raise RuntimeError(f"{what}: {n} frames, replays {replays}")
    check_counts(launches, {k: sum(v[k] for v in per.values()) for k in per_frame}, 1,
                 f"tts {what} graphed run (graph 1 captured with and without the cross "
                 f"block, graph 2 once)")
    check_counts(e_launches, {k: 2 * per["main_plain"][k] + (n - 2) * per["main"][k]
                              + n * per["depth"][k] for k in per_frame}, 1,
                 f"tts {what} eager run")
    masks = np.stack([m for m, _ in ticks])
    starved = TTS_ROLES["starved"]
    frozen = np.nonzero(~masks[3:, starved])[0]
    if len(frozen) != TTS_ROLES["starved_ticks"] or np.any(np.diff(frozen) != 1):
        raise RuntimeError(f"{what}: the starved slot sat out ticks {frozen + 3}")
    ref = sessions[0][0]
    for s in range(TTS_SLOTS):
        for sess in sessions[s]:
            check_tts_frames(sess["tokens"], cfg, f"{what} slot {s}")
            check_pcm(sess["pcm"], models["mimi"].frame_size, f"{what} slot {s}")
    if len(ref["tokens"]) != TTS_FRAMES - 2 or not ref["events"] or not ref["pcm"]:
        raise RuntimeError(f"{what}: slot 0 ran {len(ref['tokens'])} frames, "
                           f"{len(ref['events'])} Text events, {len(ref['pcm'])} PCM frames")
    for s, (i, executed) in TTS_SAME_AS_0.items():
        got = sessions[s][i]
        if (len(got["tokens"]) != executed
                or not np.array_equal(got["tokens"], ref["tokens"][:executed])
                or got["events"] != ref["events"][:len(got["events"])]
                or (executed == len(ref["tokens"]) and got["events"] != ref["events"])):
            raise RuntimeError(f"{what}: slot {s} session {i} does not repeat slot 0's frames "
                               f"and Text events")
    distinct = sum(not np.array_equal(sessions[s][0]["tokens"], ref["tokens"])
                   for s in range(7, TTS_SLOTS))
    if distinct == 0:
        raise RuntimeError(f"{what}: no slot with its own script and voice differs from slot 0")
    same = all(len(a) == len(b) and all(
        np.array_equal(x["tokens"], y["tokens"]) and x["events"] == y["events"]
        and x["eos"] == y["eos"] and len(x["pcm"]) == len(y["pcm"])
        and all(np.array_equal(p, q) for p, q in zip(x["pcm"], y["pcm"]))
        for x, y in zip(a, b)) for a, b in zip(sessions.values(), e_sessions.values()))
    same_state = all(same_bytes(a, b) for a, b in zip(tts_leaves(state), tts_leaves(eager)))
    ms = [t for _, t in ticks]
    p50, p90 = (float(np.percentile(ms, p)) for p in (50, 90))
    e_ms = [t for _, t in e_ticks]
    e50, e90 = (float(np.percentile(e_ms, p)) for p in (50, 90))
    events = sum(len(x["events"]) for v in sessions.values() for x in v)
    pcm = sum(len(x["pcm"]) for v in sessions.values() for x in v)
    phase("tts", f"{what}, {n} frames graphed: slots 1 (same script and voice), 2 (joined 5 "
          f"ticks late), 3 (starved on ticks {(frozen + 3).tolist()}) and 4 (reset at tick 22) "
          f"repeat slot 0's frames and Text events; {distinct} of {TTS_SLOTS - 7} other slots "
          f"differ; slot 5 changed its voice at tick 20, slot 6 has none; {events} Text events, "
          f"{pcm} PCM frames; launches {launches} = graph 1 {per['main']} (captured with the "
          f"cross block) + {per['main_plain']} (without) + graph 2 {per['depth']}; replays "
          f"{replays}; p50 {p50:.2f} ms, p90 {p90:.2f} ms per batched frame, the slowest "
          f"ticks {slowest_ticks(ms)} (eager: p50 {e50:.2f}, p90 {e90:.2f}, the slowest "
          f"{slowest_ticks(e_ms)}; launches {e_launches} over {len(e_ticks)} frames, 2 "
          f"without the cross block); graphed against "
          f"eager: frames, events and PCM {'equal' if same else 'DIFFER'}, every state byte "
          f"{'equal' if same_state else 'DIFFERS'}")
    if not (same and same_state):
        raise RuntimeError(f"{what}: the graphed frames differ from the eager ones")
    summary = {"p50_ms": p50, "p90_ms": p90, "max_ms": max(ms), "ms": ms, "replays": replays,
               "frames": n, "text_events": events, "pcm_frames": pcm,
               "eager": {"p50_ms": e50, "p90_ms": e90, "max_ms": max(e_ms),
                         "launches": e_launches}}
    if profile:
        g_all = tts_every_slot(state, 5, SEED + 13)
        e_all = tts_every_slot(eager, 5, SEED + 13)
        prof = profile_frames(g_all["run_frame"], 5)
        prof.update({f"p{p}_ms": float(np.percentile(g_all["ms"], p)) for p in (50, 90)})
        prof.update({f"eager_p{p}_ms": float(np.percentile(e_all["ms"], p)) for p in (50, 90)})
        prof.update(max_ms=max(g_all["ms"]), eager_max_ms=max(e_all["ms"]),
                    parts=g_all["parts"], eager_parts=e_all["parts"])
        prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / prof["p50_ms"]
        # what a frame pays when the cycle collector sweeps every generation
        t0 = time.perf_counter()
        gc.collect()
        prof["gc_full_ms"] = (time.perf_counter() - t0) * 1e3
        prof["gc_objects"] = len(gc.get_objects())
        phase("tts", f"{what}: one full pass of the cycle collector here {prof['gc_full_ms']:.2f} "
              f"ms over {prof['gc_objects']} tracked objects")
        phase("tts", f"{what}, every slot, 5 frames: graphed p50 {prof['p50_ms']:.2f} ms, p90 "
              f"{prof['p90_ms']:.2f} ms, {slowest_frame(g_all)} per batched frame (eager p50 "
              f"{prof['eager_p50_ms']:.2f}, p90 {prof['eager_p90_ms']:.2f}, "
              f"{slowest_frame(e_all)}); profiler over 5 graphed frames: {profile_line(prof)}")
        summary["profile"] = prof
    del runs, state, eager, sessions, e_sessions
    free_memory()
    return launches, summary


class GraphClock:
    """Wraps an engine's GraphedStep: CUDA events around each call, so a
    frame's card ms of the graph (its launch to its end on the stream) can
    be read after the frame."""

    def __init__(self, step):
        self.step, self.events = step, []

    def __call__(self, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.step(*args)
        end.record()
        self.events.append((start, end))
        return out

    def take_ms(self) -> float:
        """Card ms of the calls since the last take (their ends are read)."""
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return ms


def tts_every_slot(state, frames: int, seed: int) -> dict:
    """Every slot of `state` opened with a voice of its own (the resets and
    the voices' conditions applied before any timing) and fed words as the
    JAX benchmark feeds them (a sentence whenever fewer than 4 words wait),
    then `frames` ticks, each timed on the host from its inputs to its
    outputs read back, with its parts: the engine's host ms of its queued
    ops, of each graph up to its outputs read back and of the state
    machines, and the rest of the frame (feeding words, clearing the
    outboxes); the card ms of each graph (CUDA events); the ms of the cycle
    collector's passes in the frame and the oldest generation they swept
    (-1: none).  Returns {"ms", "host_ms", "parts",
    "run_frame", "voices_ms"}: parts holds one dict per frame; run_frame(i)
    runs one more tick; voices_ms is the host ms of opening the slots with
    their voices."""
    rs = np.random.RandomState(seed)
    for s in range(TTS_SLOTS):
        if state.slots[s] is not None:
            state.close_slot(s)
        state.open_slot(s)
        state.set_slot_voice(s, rs.randn(*TTS_VOICE).astype(np.float32))
    # the joins and voices (one recompute of every slot's conditions and
    # cross K/V), timed on their own and finished before the timed ticks
    t0 = time.perf_counter()
    state.apply_pending_ops()
    torch.cuda.synchronize()
    voices_ms = (time.perf_counter() - t0) * 1e3

    def run_frame(i):
        for s in range(TTS_SLOTS):
            if len(state.slots[s].state.entries) < 4:
                state.feed_words(s, ["hello world how are you today friend"])
        if state.tick() is None:
            raise RuntimeError("tts: no slot ran")
        for s in range(TTS_SLOTS):
            state.slots[s].outbox.clear()

    gc_ms, gc_t0, gc_gen = [0.0], [0.0], [-1]

    def gc_clock(event, info):
        if event == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3
            gc_gen[0] = max(gc_gen[0], info["generation"])
    steps = {"main": state.main[True], "depth": state.depth}
    clocks = {k: GraphClock(v) for k, v in steps.items()}
    state.main[True], state.depth = clocks["main"], clocks["depth"]
    gc.callbacks.append(gc_clock)
    ms, parts = [], []
    try:
        for i in range(frames):
            gc_ms[0], gc_gen[0] = 0.0, -1
            t0 = time.perf_counter()
            run_frame(i)
            ms.append((time.perf_counter() - t0) * 1e3)
            parts.append({**{f"{k}_host_ms": v for k, v in state.frame_ms.items()},
                          "other_host_ms": ms[-1] - sum(state.frame_ms.values()),
                          **{f"{k}_card_ms": c.take_ms() for k, c in clocks.items()},
                          "gc_ms": gc_ms[0], "gc_generation": gc_gen[0]})
    finally:
        gc.callbacks.remove(gc_clock)
        state.main[True], state.depth = steps["main"], steps["depth"]
    return {"ms": ms, "host_ms": [p["machines_host_ms"] for p in parts], "parts": parts,
            "run_frame": run_frame, "voices_ms": voices_ms}


def slowest_frame(r: dict) -> str:
    """The slowest frame of a tts_every_slot run and its parts."""
    i = int(np.argmax(r["ms"]))
    return (f"max {r['ms'][i]:.2f} ms (frame {i} of {len(r['ms'])}: "
            + ", ".join(f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in r["parts"][i].items()) + ")")


def run_tts(dev, card: str) -> dict:
    """The batched TTS path at B = TTS_SLOTS: the greedy isolation run with
    the int4 KV cache, graphed and eager; a sampled run of every slot, 40
    graphed frames and 10 eager ones, with a profiler pass; then the greedy
    run with the int8 KV cache and 5 frames of every slot."""
    from dataclasses import replace

    from moshi_tpu_torch.models.lm import LMModel

    models = build_tts(dev)
    lm = models["lm"]
    per = tts_launches(lm.config, models["lm_params"], TTS_SLOTS)
    per_frame = {k: per["main"][k] + per["depth"][k] for k in per["main"]}
    if any(per_frame[k] for k in ("q4_gemv", "q4_mma", "q4_wgmma")):
        raise RuntimeError("the tts frame would run a q4 kernel")
    prefix = tts_get_prefix(dev, models, card)
    greedy_launches, greedy = tts_greedy(dev, models, lm, "greedy")

    runs = {}
    for graphed, n in ((True, FRAMES), (False, EAGER_FRAMES)):
        free_memory()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        state = tts_engine(dev, models, lm, TTS_TEMP, graphed)
        zero_counts()
        r = tts_every_slot(state, n, SEED + 14)
        launches = read_counts()
        kind = "graphed" if graphed else "eager"
        check_counts(launches, per_frame, 1 if graphed else n, f"tts sampled {kind} run")
        run = {"launches": launches, "frames": n,
               **{f"p{p}_ms": float(np.percentile(r["ms"], p)) for p in (50, 75, 90)},
               "max_ms": max(r["ms"]), "slowest": slowest_frame(r), "parts": r["parts"],
               "host_ms_p50": float(np.percentile(r["host_ms"], 50)),
               "voices_ms": r["voices_ms"],
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "engine_peak_gib": (torch.cuda.max_memory_allocated(dev) - before) / 2 ** 30}
        if graphed:
            run["replays"] = {"main": state.main[True].replays, "depth": state.depth.replays}
            if run["replays"] != {"main": n, "depth": n}:
                raise RuntimeError(f"tts sampled: replays {run['replays']} for {n} frames")
            prof = profile_frames(r["run_frame"], 5)
            prof["idle_share"] = 1 - prof["busy_ms_per_frame"] / run["p50_ms"]
            run["profile"] = prof
        for s in range(TTS_SLOTS):
            if state.slots[s].state.transcript == []:
                raise RuntimeError(f"tts sampled {kind}: slot {s} said no word")
        runs[kind] = run
        del state
    g, e = runs["graphed"], runs["eager"]
    phase("tts", f"sampled (temp {TTS_TEMP}), {g['frames']} frames x {TTS_SLOTS} slots graphed: "
          f"p50 {g['p50_ms']:.2f} ms, p75 {g['p75_ms']:.2f} ms, p90 {g['p90_ms']:.2f} ms, "
          f"{g['slowest']} per batched frame, {g['p50_ms'] / TTS_SLOTS:.3f} ms per stream "
          f"at p50, of it "
          f"{g['host_ms_p50']:.3f} ms of host Python in the DSM machines (opening the "
          f"{TTS_SLOTS} slots with their voices, one recompute of every slot's conditions "
          f"and cross K/V: {g['voices_ms']:.1f} ms); peak "
          f"{g['peak_gib']:.2f} GiB allocated, {g['engine_peak_gib']:.2f} GiB of it above what "
          f"the card held before the engine; launches {g['launches']} (1 captured frame), "
          f"replays {g['replays']} ({card})")
    phase("tts", f"sampled, {e['frames']} frames x {TTS_SLOTS} slots eager: p50 "
          f"{e['p50_ms']:.2f} ms, p90 {e['p90_ms']:.2f} ms, {e['slowest']} per batched "
          f"frame; peak {e['peak_gib']:.2f} GiB; launches {e['launches']} ({card})")
    phase("tts", f"profiler over 5 graphed sampled frames: {profile_line(g['profile'])}")

    lm8 = LMModel(replace(lm.config, kv_cache_dtype="int8"))
    int8_launches, int8 = tts_greedy(dev, models, lm8, "int8 greedy", profile=True)
    configs = configs_tts(dev, card, models)
    checkpoint = write_tts_checkpoint(dev, card, models, TTS_DIR)
    del models
    free_memory()
    return {"checkpoint": checkpoint, "configs": configs,
            "launches": {"tts_greedy": greedy_launches, "tts_sampled": g["launches"],
                         "tts_int8_greedy": int8_launches,
                         **{f"configs_tts_{k}_{run}": v[key] for k, v in configs.items()
                            for run, key in (("graphed", "launches"),
                                             ("eager", "eager_launches"))}},
            "per_frame": {"tts": per_frame,
                          "configs_tts_32_rows": configs["no_cfg"]["per_frame"],
                          "tts_int8": {**per_frame, "decode_attention_int4": 0,
                                       "cache_write_int4": 0,
                                       "decode_attention_int8": lm8.config.num_layers}},
            "sampled": g, "sampled_eager": e, "greedy": greedy, "int8_greedy": int8,
            "get_prefix": prefix}


# -------------------------------------------------------------- tts_serve
TTS_DIR = ROOT / "build" / "tts_checkpoint"
TTS_MODEL_ID = {"sig": "smoke", "epoch": 1}   # voice files end ".smoke@1.safetensors"
TTS_VOICES = 4             # seeded speaker_wavs files in the voice directory
# the Mimi's block of config.json, written beside the checkpoint when set
# (None: the v0.1 Mimi the loaders build by default)
TTS_MIMI_CONFIG = None
TTS_SERVE_CFG = 2.0        # batched_tts's cfg_coef: the distilled model's `cfg` condition
TTS_SERVE_LEAVE = 15       # frames the resuming batched session runs before it leaves
TTS_SERVE_CHANGE = 10      # the frame at which a batched session changes its voice
TTS_SERVE_TEMP = 0.6       # the tts module's temperature (each session seeded alike)
MIMI_FRAMES = 40           # frames each Mimi socket client sends
TTS_SERVE_TIMEOUT = 120    # seconds a session waits for a loop


def piece_words(n: int, salt: int) -> str:
    """n words of the synthetic tokenizer (one piece each), seeded by salt."""
    rs = np.random.RandomState(SEED + 200 + salt)
    return " ".join(f"w{i}" for i in rs.randint(10, 30_000, n))


def voice_name(i: int) -> str:
    return f"voice{i}.{TTS_MODEL_ID['sig']}@{TTS_MODEL_ID['epoch']}.safetensors"


def write_tts_checkpoint(dev, card: str, models, out: Path) -> dict:
    """[tts]'s seeded weights as a native TTS checkpoint: the int8 LM (its
    config's int4 KV at context TTS_CONTEXT) with the conditioners' tensors
    under their PyTorch names in the same file, the bf16 Mimi, a synthetic
    32000-piece tokenizer, config.json (tts_config, conditioners, fuser,
    model_id) and a voice directory of TTS_VOICES seeded speaker_wavs files
    [1, D, T]; then loaded back, every leaf held equal to the written one.
    Returns the bytes and the seconds of the write and the load."""
    import dataclasses
    import shutil
    from moshi_tpu_torch.models.loaders import CheckpointInfo
    from moshi_tpu_torch.models.native_ckpt import flatten_tree, save_mimi_params
    from moshi_tpu_torch.text.spm import spm_model_bytes
    from moshi_tpu_torch.utils.safetensors import save_file

    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cfg = models["lm"].config
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = flatten_tree(models["lm_params"])
    for name, p in models["cp_params"].items():
        prefix = f"condition_provider.conditioners.{name}"
        if "embed" in p:
            flat[f"{prefix}.embed.weight"] = p["embed"]
        flat[f"{prefix}.output_proj.weight"] = p["output_proj"].t().contiguous()
        flat[f"{prefix}.learnt_padding"] = p["learnt_padding"]
    nbytes = save_file(flat, out / "model.int8.native.safetensors")
    nbytes += save_mimi_params(out / "mimi.native.safetensors", models["mimi"],
                               models["mimi_params"])
    (out / "tokenizer_spm_32k_3.model").write_bytes(spm_model_bytes(cfg.text_card))
    config = {k: list(v) if isinstance(v, tuple) else v
              for k, v in dataclasses.asdict(cfg).items()}
    config.update(moshi_name="model.int8.native.safetensors",
                  mimi_name="mimi.native.safetensors",
                  tokenizer_name="tokenizer_spm_32k_3.model", model_type="tts",
                  native_format=True, model_id=TTS_MODEL_ID,
                  tts_config={"audio_delay": TTS_DELAY_STEPS / 12.5,
                              "max_speakers": TTS_MAX_SPEAKERS},
                  conditioners={"speaker_wavs": {"type": "tensor",
                                                 "tensor": {"dim": TTS_VOICE[1]}},
                                "cfg": {"type": "lut", "lut": {**TTS_CFG, "tokenizer": "noop"}}},
                  fuser={"cross": ["speaker_wavs"], "sum": ["cfg"]})
    if TTS_MIMI_CONFIG is not None:
        (out / "mimi_config.json").write_text(json.dumps(TTS_MIMI_CONFIG))
        config["mimi_config_name"] = "mimi_config.json"
    (out / "config.json").write_text(json.dumps(config, indent=2))
    (out / "voices").mkdir()
    rs = np.random.RandomState(SEED + 210)
    for i in range(TTS_VOICES):
        emb = rs.randn(1, TTS_VOICE[1], TTS_VOICE[0]).astype(np.float32)   # [1, D, T]
        save_file({"speaker_wavs": torch.from_numpy(emb)}, out / "voices" / voice_name(i))
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    info = CheckpointInfo.from_dir(out)
    _, lm_params = info.get_moshi(device=dev)
    _, mimi_params = info.get_mimi(device=dev)
    _, _, cp_params = info.get_conditioners(cfg.dim, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    leaves = (same_tree(lm_params, models["lm_params"])
              + same_tree(mimi_params, models["mimi_params"])
              + same_tree(cp_params, models["cp_params"]))
    del lm_params, mimi_params, cp_params
    free_memory()
    phase("tts_serve", f"checkpoint written to build/{out.name}: {nbytes / 1e9:.3f} GB "
          f"(the int8 LM with the conditioners' tensors, the bf16 Mimi) in {write_s:.2f} s, "
          f"{TTS_VOICES} voices of {TTS_VOICE[0]} x {TTS_VOICE[1]}; loaded back in "
          f"{load_s:.2f} s, {leaves} leaves each torch.equal to the written one ({card})")
    return {"bytes": nbytes, "write_s": write_s, "load_s": load_s, "leaves": leaves}


def tts_build_launches(per: dict) -> dict:
    """The launches of one TTS engine's warm-up (two frames in each mode of
    graph 1, each with graph 2) and of its capture (graph 1 in each mode,
    graph 2 once), from tts_launches' counts per graph."""
    return {k: 3 * (per["main"][k] + per["main_plain"][k]) + 5 * per["depth"][k]
            for k in TPU_KERNELS}


def run_tts_cli(dev, card: str) -> dict:
    """moshi_tpu_torch.run_tts's main in-process on the checkpoint: two texts
    in two voices named in its voice directory, greedy.  Its two wavs, the
    seconds of audio per second, and its launches: K3 and K4 + K5 only, a
    whole number of frames of the eager B = 2 generate."""
    import shutil
    from moshi_tpu_torch import audio
    from moshi_tpu_torch.models.loaders import CheckpointInfo
    from moshi_tpu_torch.run_tts import main as run_tts_main

    outdir = TTS_DIR / "wavs"
    argv = ["--device", str(dev), "--checkpoint-dir", str(TTS_DIR), "--temp", "0", "--voice-repo",
            str(TTS_DIR / "voices"), "--text", piece_words(2, 0), "--text", piece_words(2, 1),
            "--voice", "voice0", "--voice", "voice1", str(outdir)]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    paths = run_tts_main(argv)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    wavs = [audio.read_wav(p)[0][0] for p in paths]
    rate = 24_000 if TTS_MIMI_CONFIG is None else TTS_MIMI_CONFIG["sample_rate"]
    audio_s = sum(len(w) for w in wavs) / rate
    if len(paths) != 2 or not all(len(w) and np.isfinite(w).all() for w in wavs):
        raise RuntimeError(f"run_tts: wavs of {[len(w) for w in wavs]} samples")
    lm, lm_params = CheckpointInfo.from_dir(TTS_DIR).get_moshi(device=dev)
    per = tts_launches(lm.config, lm_params, 2)
    del lm_params
    free_memory()
    # generate runs graph 1's work every frame, and the depformer's only
    # once the text-audio delay has passed (before, the audio is replaced)
    frames = launches["decode_attention_int4"] // max(per["main"]["decode_attention_int4"], 1)
    depth = frames - TTS_DELAY_STEPS
    want = {k: frames * per["main"][k] + depth * per["depth"][k] for k in TPU_KERNELS}
    if depth <= 0 or launches != want:
        raise RuntimeError(f"run_tts: launches {launches}, not {want} of {frames} frames")
    shutil.rmtree(outdir)
    phase("tts_serve", f"run_tts main (--text x 2, --voice voice0 and voice1 named in the voice "
          f"directory, greedy): 2 wavs, {audio_s:.2f} s of audio in {seconds:.2f} s "
          f"({audio_s / seconds:.2f} s of audio per s, the load included); launches "
          f"{ {k: v for k, v in launches.items() if v} } = {frames} eager frames at B = 2, the "
          f"depformer in {depth} of them, K3 and K4 + K5 only ({card})")
    return {"launches": launches, "seconds": seconds, "audio_s": audio_s, "frames": frames}


def tts_serve_toml() -> str:
    voices = TTS_DIR / "voices"
    return f"""
[modules.batched]
type = "batched_tts"
route = "/api/tts_batched"
checkpoint_dir = "{TTS_DIR}"
batch_size = {TTS_SLOTS}
kv_cache = "int4"
context = {TTS_CONTEXT}
mimi_dtype = "bf16"
temp = 0.0
cfg_coef = {TTS_SERVE_CFG}
voice_dir = "{voices}"

[modules.tts]
type = "tts"
route = "/api/tts_streaming"
checkpoint_dir = "{TTS_DIR}"
kv_cache = "int8"
context = {TTS_CONTEXT}
temp = {TTS_SERVE_TEMP}
voice_dir = "{voices}"

[modules.mimi]
type = "mimi"
route = "/api/mimi"
checkpoint_dir = "{TTS_DIR}"
rooms = ["room"]
"""


def voice_file(i: int) -> np.ndarray:
    """The speaker embedding [T, D] of the checkpoint's voice file i."""
    from moshi_tpu_torch.models.tts import TTSModel
    return TTSModel.load_voice_embedding(TTS_DIR / "voices" / voice_name(i))[0]


async def until(cond, what: str):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > TTS_SERVE_TIMEOUT:
            raise RuntimeError(f"tts_serve: timed out waiting for {what}")
        await asyncio.sleep(0.002)


async def batched_tts_sessions(state) -> dict:
    """The batched_tts module driven through its own acquire_slot /
    set_slot_voice / feed_words / feed_eos and the slot queues its socket
    handler reads, under its run_loop: 15 greedy sessions with voices.  0
    and 1 are twins; 2, their twin too, leaves after TTS_SERVE_LEAVE frames
    with a resume id, a tenant takes and dirties its slot, and it resumes on
    another; 3 changes its voice at frame TTS_SERVE_CHANGE; 4.. have scripts
    and voices of their own.  Returns each session's token rows, Text
    events and PCM frames, its time from its words to its first PCM frame,
    and the slots of the resume."""
    rows: dict[int, list] = {}
    step = state.step_batch

    def recording(active, sessions=None):
        out, pcm = step(active, sessions)
        for b, s in zip(active, sessions or [state.slots[b] for b in active]):
            rows.setdefault(id(s), []).append(out[b, :, 0])
        return out, pcm
    state.step_batch = recording
    plans = [(piece_words(3, 10), 0)] * 3 + [(piece_words(3, 11), 1)] + [
        (piece_words(3, 12 + i), i % TTS_VOICES) for i in range(11)]
    out = {"events": {}, "pcm": {}, "ttfa_ms": {}, "eos": {}}
    sessions = {}

    async def collect(i, q, t_fed, stop=None):
        """Read the queue into session i's results up to its Eos (True), or
        until `stop()` holds with the queue empty (False)."""
        while not (stop is not None and stop() and q.empty()):
            try:
                kind, payload = await asyncio.wait_for(
                    q.get(), 0.01 if stop is not None else TTS_SERVE_TIMEOUT)
            except asyncio.TimeoutError:
                if stop is None:
                    raise
                continue
            if kind == "eos":
                return True
            if kind == "event":
                out["events"][i].append(payload)
                continue
            if not out["pcm"][i]:
                out["ttfa_ms"][i] = (time.perf_counter() - t_fed) * 1e3
            out["pcm"][i].append(payload)
        return False

    async def session(i, words, voice):
        slot = await state.acquire_slot()
        if slot is None:
            raise RuntimeError(f"tts_serve batched: no slot for session {i}")
        out["events"][i], out["pcm"][i] = [], []
        rid = state.issue_resume_id(slot) if i == 2 else None
        sessions[i] = s = state.slots[slot]
        state.set_slot_voice(slot, voice_file(voice))
        state.feed_words(slot, [words])
        state.feed_eos(slot)
        t_fed = time.perf_counter()
        q = state.slot_queues[slot]
        if i == 3:
            await collect(i, q, t_fed, stop=lambda: s.offset >= TTS_SERVE_CHANGE)
            state.set_slot_voice(slot, voice_file(2))
        if i == 2:
            await collect(i, q, t_fed, stop=lambda: s.offset >= TTS_SERVE_LEAVE)
            await state.release_slot(slot)
            tenant = await state.acquire_slot()
            state.set_slot_voice(tenant, voice_file(3))
            state.feed_words(tenant, [piece_words(6, 40)])
            back = await state.acquire_slot(rid)
            if back is None or not state.slot_resumed.get(back) or back in (slot, tenant):
                raise RuntimeError(f"tts_serve batched: resumed on slot {back} (left {slot}, "
                                   f"tenant {tenant})")
            out["resume"] = {"left": slot, "tenant": tenant, "back": back}
            await until(lambda: state.slots[tenant].offset >= 5, "the tenant's frames")
            await state.release_slot(tenant)
            slot, q = back, state.slot_queues[back]
        out["eos"][i] = await collect(i, q, t_fed)
        await state.release_slot(slot)

    try:
        await asyncio.gather(*(session(i, w, v) for i, (w, v) in enumerate(plans)))
    finally:
        state.step_batch = step
    out["tokens"] = {i: np.stack(rows[id(s)]) for i, s in sessions.items()}
    return out


async def tts_module_sessions(streamer) -> list:
    """The tts module's streamer driven as its socket handler drives it (its
    lock, a reset, run_session) with a voice, words and Eos, three sessions
    in turn: 1 and 3 in the same voice with the same words, 2 with others.
    Returns each session's token rows, JSON messages, PCM frames and time
    from its words to its first PCM frame."""
    from moshi_tpu_torch.serve.tts_ws import run_session

    rows = []
    step = streamer.engine.step_batch

    def recording(active, sessions=None):
        res = step(active, sessions)
        rows.append(res[0][0, :, 0])
        return res
    streamer.engine.step_batch = recording
    out = []
    try:
        for v, words in ((0, piece_words(3, 20)), (1, piece_words(4, 21)),
                         (0, piece_words(3, 20))):
            voice = voice_file(v)
            msgs = [json.dumps({"type": "Voice", "embeddings": voice.ravel().tolist(),
                                "shape": list(voice.shape)}),
                    json.dumps({"type": "Text", "text": words}), json.dumps({"type": "Eos"})]
            got = {"json": [], "pcm": [], "t_fed": 0.0, "ttfa_ms": None}

            async def messages():
                for m in msgs:
                    if json.loads(m)["type"] == "Text":
                        got["t_fed"] = time.perf_counter()
                    yield m

            async def send(item):
                if isinstance(item, dict):
                    got["json"].append(item)
                    return
                if not got["pcm"]:
                    got["ttfa_ms"] = (time.perf_counter() - got["t_fed"]) * 1e3
                got["pcm"].append(np.array(item))

            rows.clear()
            async with streamer.lock:
                streamer.reset()
                await run_session(streamer, messages(), send)
            got["tokens"] = np.stack(rows)
            out.append(got)
    finally:
        streamer.engine.step_batch = step
    return out


class RawWriter:
    """The room's audio as raw f32le (the card's machine has no libopus)."""

    def append_pcm(self, pcm):
        return np.ascontiguousarray(pcm, np.float32).tobytes()


async def mimi_clients(base: str, state, rooms) -> dict:
    """The mimi module over aiohttp on 127.0.0.1: two tokenizer clients at
    once, MIMI_FRAMES frames of seeded PCM each in chunks of ragged sample
    counts, then their codes back for PCM; then a room with one producer
    and two listeners (its audio raw f32le)."""
    import aiohttp
    from moshi_tpu_torch.serve.mimi_ws import MimiRoom

    fs, K = state.mimi.frame_size, state.mimi.num_codebooks
    rs = np.random.RandomState(SEED + 230)
    pcms = [(0.3 * rs.randn(MIMI_FRAMES * fs)).astype(np.float32) for _ in range(2)]

    async def client(http, i):
        ws = await http.ws_connect(f"{base}/api/mimi")
        cuts = np.cumsum(np.random.RandomState(i).randint(fs // 3, 3 * fs, 4 * MIMI_FRAMES))
        for chunk in np.split(pcms[i], cuts[cuts < len(pcms[i])]):
            await ws.send_bytes(b"\x01" + chunk.tobytes())
        codes = []
        while sum(c.shape[-1] for c in codes) < MIMI_FRAMES:
            m = await ws.receive_bytes(timeout=TTS_SERVE_TIMEOUT)
            codes.append(np.frombuffer(m[1:], np.int32).reshape(K, -1))
        codes = np.concatenate(codes, axis=-1)
        await ws.send_bytes(b"\x09" + codes.tobytes())
        back = await ws.receive_bytes(timeout=TTS_SERVE_TIMEOUT)
        await ws.close()
        return codes, np.frombuffer(back[1:], np.float32)

    out = {"pcm": pcms}
    async with aiohttp.ClientSession() as http:
        t0 = time.perf_counter()
        out["clients"] = await asyncio.gather(*(client(http, i) for i in range(2)))
        out["seconds"] = time.perf_counter() - t0
        rooms.rooms["room"] = MimiRoom(state, writer=RawWriter())
        listeners = [await http.ws_connect(f"{base}/api/mimi/room/recv") for _ in range(2)]
        heard = [[await ws.receive_bytes(timeout=TTS_SERVE_TIMEOUT)] for ws in listeners]
        producer = await http.ws_connect(f"{base}/api/mimi/room/send")
        out["room_codes"] = out["clients"][0][0][:, :5]
        await producer.send_bytes(b"\x09" + out["room_codes"].T.astype(np.uint32).tobytes())
        for ws, got in zip(listeners, heard):
            for _ in range(5):
                got.append(await ws.receive_bytes(timeout=TTS_SERVE_TIMEOUT))
        for ws in listeners + [producer]:
            await ws.close()
        out["heard"] = heard
    return out


async def drive_tts_serve(app, batched, streamer, mimi_state, rooms) -> dict:
    from aiohttp import web

    runner = web.AppRunner(app)
    await runner.setup()
    port = free_port()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    out = {}
    try:
        batched.frame_times.clear()
        batched.ops_times.clear()
        out["batched"] = await batched_tts_sessions(batched)
        out["batched_ms"] = list(batched.frame_times)
        out["batched_ops_ms"] = list(batched.ops_times)
        streamer.frame_times.clear()
        out["tts"] = await tts_module_sessions(streamer)
        out["tts_ms"] = list(streamer.frame_times)
        out["mimi"] = await mimi_clients(f"http://127.0.0.1:{port}", mimi_state, rooms)
    finally:
        await runner.cleanup()
    return out


def same_tts_session(a: dict, b: dict) -> bool:
    return (np.array_equal(a["tokens"], b["tokens"]) and a["events"] == b["events"]
            and len(a["pcm"]) == len(b["pcm"])
            and all(np.array_equal(x, y) for x, y in zip(a["pcm"], b["pcm"])))


def run_tts_serve(dev, card: str, tts: dict) -> dict:
    """The TTS and codec entry points over [tts]'s checkpoint: run_tts's
    main; then the worker on one TOML of three modules (batched_tts at B =
    TTS_SLOTS with the int4 KV cache and the `cfg` condition, tts with the
    int8 KV cache, mimi with one room), built by build_app as `main` builds
    it: the batched module's sessions through its slot API under its
    run_loop, the tts module's three sessions in turn, the Mimi sockets over
    aiohttp on 127.0.0.1.  The launches of the build: each TTS module's
    warm-up and one capture; none while serving."""
    import tomllib
    from moshi_tpu_torch.serve.worker import build_app

    t_phase = time.perf_counter()
    cli = run_tts_cli(dev, card)
    free_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    app = build_app(tomllib.loads(tts_serve_toml()), device=dev)
    build_s = time.perf_counter() - t0
    built = read_counts()
    modules = app["modules"]
    batched, streamer, mimi_state = (modules[k]["state"] for k in ("batched", "tts", "mimi"))
    for name, m in modules.items():
        phase("tts_serve", f"module {name} ({m['type']}): loaded in {m['load_s']:.2f} s, "
              f"warm-up and captures {m['warmup_s']:.2f} s")
    engine = streamer.engine
    per_b = tts_launches(batched.tts.lm.config, batched.lm_params, TTS_SLOTS)
    per_t = tts_launches(engine.tts.lm.config, engine.lm_params, 1)
    b_build, t_build = tts_build_launches(per_b), tts_build_launches(per_t)
    expected = {k: b_build[k] + t_build[k] for k in TPU_KERNELS}
    if built != expected:
        raise RuntimeError(f"tts_serve: build launched {built}, expected {expected}")
    if (batched.mult, batched.cfg_condition, batched.voice_frames) != (1, TTS_SERVE_CFG,
                                                                       TTS_VOICE[0]):
        raise RuntimeError(f"tts_serve: the batched module runs mult {batched.mult}, cfg "
                           f"{batched.cfg_condition}, voices of {batched.voice_frames} frames")

    out = asyncio.run(drive_tts_serve(app, batched, streamer, mimi_state,
                                      modules["mimi"]["rooms"]))
    launches = read_counts()
    if launches != built:
        raise RuntimeError(f"tts_serve: serving launched kernels outside the graphs: "
                           f"{launches} after the build's {built}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    cfg = batched.tts.lm.config
    fs = batched.tts.mimi.frame_size

    # batched: twins, the resumed twin, every session whole
    b = out["batched"]
    sess = {i: {"tokens": b["tokens"][i], "events": b["events"][i], "pcm": b["pcm"][i]}
            for i in b["tokens"]}
    for i, s in sess.items():
        check_tts_frames(s["tokens"], cfg, f"tts_serve batched session {i}")
        check_pcm(s["pcm"], fs, f"tts_serve batched session {i}")
        if not (b["eos"][i] and s["events"] and s["pcm"]):
            raise RuntimeError(f"tts_serve batched: session {i} ended {b['eos'][i]} with "
                               f"{len(s['events'])} words and {len(s['pcm'])} PCM frames")
    for i in (1, 2):
        if not same_tts_session(sess[i], sess[0]):
            raise RuntimeError(f"tts_serve batched: session {i} differs from its twin 0")
    distinct = sum(not np.array_equal(sess[i]["tokens"], sess[0]["tokens"])
                   for i in range(4, len(sess)))
    if distinct == 0:
        raise RuntimeError("tts_serve batched: no session of its own differs from session 0")
    b50, b90 = (float(np.percentile(out["batched_ms"], p)) for p in (50, 90))
    slow = slowest_ticks(out["batched_ms"], 4)
    ttfa = list(b["ttfa_ms"].values())
    r = b["resume"]
    phase("tts_serve", f"batched_tts B = {TTS_SLOTS} int4 KV, cfg condition {TTS_SERVE_CFG}, "
          f"through run_loop: {len(sess)} greedy sessions with voices, of "
          f"{min(len(s['tokens']) for s in sess.values())}-"
          f"{max(len(s['tokens']) for s in sess.values())} frames each; "
          f"twins 0 and 1 equal in tokens, words and PCM; session 2 left slot {r['left']} "
          f"after frame {TTS_SERVE_LEAVE}, a tenant took and dirtied it, and it resumed on "
          f"slot {r['back']} and equals its twin; session 3 changed its voice at frame "
          f"{TTS_SERVE_CHANGE}; {distinct} of {len(sess) - 4} sessions of their own differ; "
          f"{len(out['batched_ms'])} frames p50 {b50:.2f} ms, p90 {b90:.2f} ms per batched "
          f"frame, the slowest {slow} (frame: ms; a voice change, restore or join with a voice "
          f"recomputes every slot's conditions and cross K/V before the next frame) ([tts] "
          f"greedy graphed p50 {tts['greedy']['p50_ms']:.2f} ms in this run), "
          f"and {len(out['batched_ops_ms'])} turns of slot ops between them, "
          f"{sum(out['batched_ops_ms']):.1f} ms of host time in all; first audio "
          f"{float(np.percentile(ttfa, 50)):.1f} ms p50, {max(ttfa):.1f} ms max after the "
          f"words ({card})")

    # tts: session 3 repeats session 1 on the reset, seeded streamer
    t = out["tts"]
    for i, s in enumerate(t):
        check_tts_frames(s["tokens"], engine.tts.lm.config, f"tts_serve tts session {i + 1}")
        check_pcm(s["pcm"], fs, f"tts_serve tts session {i + 1}")
        if s["json"][-1] != {"type": "Eos"} or not s["pcm"]:
            raise RuntimeError(f"tts_serve tts: session {i + 1} ended with {s['json'][-1:]}")
    t[0]["events"], t[2]["events"] = t[0]["json"], t[2]["json"]
    if not same_tts_session(t[2], t[0]) or np.array_equal(t[1]["tokens"], t[0]["tokens"]):
        raise RuntimeError("tts_serve tts: session 3 differs from session 1, or 2 equals it")
    t50, t90 = (float(np.percentile(out["tts_ms"], p)) for p in (50, 90))
    t_ttfa = [s["ttfa_ms"] for s in t]
    phase("tts_serve", f"tts (one captured streamer at B = 1, int8 KV, temp "
          f"{TTS_SERVE_TEMP}): 3 sessions in turn of {[len(s['tokens']) for s in t]} frames; "
          f"session 3 equals session 1 in tokens, words and PCM, session 2 differs; "
          f"{len(out['tts_ms'])} frames p50 {t50:.2f} ms, p90 {t90:.2f} ms; first audio "
          f"{[round(x, 1) for x in t_ttfa]} ms after the words ({card})")

    # mimi: codes of encode_step from a fresh state, PCM of decode_step
    m = out["mimi"]
    mimi, params = mimi_state.mimi, mimi_state.params
    for i, (codes, back) in enumerate(m["clients"]):
        enc = mimi.init_encode_state(1, mimi_state.dtype, dev)
        dec = mimi.init_decode_state(1, mimi_state.dtype, dev)
        x = torch.from_numpy(m["pcm"][i]).to(dev, mimi_state.dtype)
        ref = torch.cat([mimi.encode_step(params, enc, x[k * fs:(k + 1) * fs][None, None])[0]
                         for k in range(MIMI_FRAMES)], -1)[0].cpu().numpy()
        c = torch.from_numpy(codes.astype(np.int64)).to(dev)
        pcm = torch.cat([mimi.decode_step(params, dec, c[None, :, k:k + 1])[0]
                         for k in range(MIMI_FRAMES)], -1)[0, 0].float().cpu().numpy()
        if not (np.array_equal(codes, ref) and np.array_equal(back, pcm)):
            raise RuntimeError(f"tts_serve mimi: client {i}'s codes or PCM differ from "
                               f"encode_step / decode_step from a fresh state")
    heard = m["heard"]
    dec = mimi.init_decode_state(1, mimi_state.dtype, dev)
    c = torch.from_numpy(m["room_codes"].astype(np.int64)).to(dev)
    room_pcm = torch.cat([mimi.decode_step(params, dec, c[None, :, k:k + 1])[0]
                          for k in range(c.shape[-1])], -1)[0, 0].float().cpu().numpy()
    got = np.concatenate([np.frombuffer(x[1:], np.float32) for x in heard[0][1:]])
    if heard[0] != heard[1] or heard[0][0] != b"\x00" * 9 or not np.array_equal(got, room_pcm):
        raise RuntimeError("tts_serve mimi: the room's listeners heard different bytes, or "
                           "not the producer's codes decoded")
    fps = 2 * 2 * MIMI_FRAMES / m["seconds"]
    phase("tts_serve", f"mimi over the socket: 2 clients x {MIMI_FRAMES} frames in ragged "
          f"chunks, codes equal to encode_step's from a fresh state, their PCM to "
          f"decode_step's; {fps:.1f} frames per second encoded and decoded (eager, batch 1); "
          f"a room's two listeners heard the same {sum(len(x) for x in heard[0])} bytes, the "
          f"producer's 5 frames decoded ({card})")
    used = {k: v for k, v in built.items() if v}
    phase("tts_serve", f"build_app {build_s:.2f} s; launches {used} = warm-up + captures of "
          f"batched_tts and tts, none while serving; peak {peak:.2f} GiB allocated; the "
          f"phase took {time.perf_counter() - t_phase:.1f} s ({card})")
    seconds = {k: {"load_s": mm["load_s"], "warmup_s": mm["warmup_s"]}
               for k, mm in modules.items()}
    del app, modules, batched, streamer, engine, mimi_state
    return {"launches": {k: cli["launches"][k] + built[k] for k in TPU_KERNELS},
            "run_tts": {k: v for k, v in cli.items() if k != "launches"},
            "build_s": build_s, "modules": seconds,
            "batched_p50_ms": b50, "batched_p90_ms": b90,
            "batched_ops_ms": out["batched_ops_ms"], "batched_ms": out["batched_ms"],
            "batched_ttfa_p50_ms": float(np.percentile(ttfa, 50)),
            "batched_ttfa_max_ms": max(ttfa), "tts_p50_ms": t50, "tts_p90_ms": t90,
            "tts_ttfa_ms": t_ttfa, "mimi_frames_per_s": fps, "peak_gib": peak,
            "checkpoint": tts["checkpoint"]}


# ------------------------------------------------------------------ train
# [train] (a): LoRA over [slice]'s Moshi-7B weights (q4 temporal linears and
# text head, an int8 depformer, bf16), adapters of rank TRAIN_LORA["rank"]
# on every linear in f32, lora_optimizer(make_optimizer(TRAIN_OPT)), seeded
# codes [2, 17, 256] repeated every step (synthetic_repeat): 512 rows for
# each temporal linear
TRAIN_LORA = {"batch": 2, "frames": 256, "steps": 6, "rank": 128, "scaling": 2.0}
TRAIN_OPT = {"lr": 1e-3, "grad_clip": 1.0}
# (a2): the same over Moshi-7B's int8 serving weights (every linear int8,
# quantize_lm_params' default mode), depth cut to TRAIN_INT8["layers"]: the
# int8 GEMV at 512 rows under grad, 32 launches a linear
TRAIN_INT8 = {"layers": 8, "steps": 2}
# stated before the first card run (PERF.md §6): the step-0 gradient of
# every adapter with the kernels against the same step through the plain
# GEMVs on the card, ||g_kernel - g_plain|| / ||g_plain|| over all of them
# (HIBIKI_WITNESS_BOUND's model), and the losses' relative difference; remat
# against no remat, the same norm over all gradients.  The witness holds
# the bound against the plain GEMVs in f32 (the kernels' arithmetic: exact
# weights, f32 sums); in bf16 they round each weight before the product,
# which 32 random layers spread to 5.239e-2 on an H100 (PERF.md §6), so
# that reading is printed beside it, and the gradient with every base's
# backward dropped must read above the bound
TRAIN_WITNESS_BOUND = 5e-2
TRAIN_LOSS_BOUND = 1e-2
TRAIN_REMAT_BOUND = 1e-3
# (b): LMGen at B = 1 over the trained tree, TRAIN_GEN_FRAMES eager frames;
# the text logits of fuse_lora_params in bf16 against the LoRA tree's over
# TRAIN_FUSED_FRAMES frames (offline forward_text), ||diff|| / ||LoRA||
TRAIN_GEN_FRAMES = 8
TRAIN_FUSED_FRAMES = 32
TRAIN_FUSED_BOUND = 5e-2
# (c): the CLI on Mimi v0.1 in f32 with 8 codebooks, B = 4 x 2 s of seeded
# PCM repeated every step, 20 steps saved at 10; the resumed run's final
# loss against the uninterrupted one's, relative.  Both calls pass
# --deterministic (cuDNN's, cuBLAS's and index_add's deterministic
# algorithms).  At lr 1e-3 the randomly initialised encoder outran its EMA
# codebooks (commit losses up to ~3700) and the last loss was a draw;
# at 1e-4 the loss fell at all but 1 of 19 steps (PERF.md §6)
TRAIN_MIMI = {"batch_size": 4, "seq_len": 25, "steps": 20, "save_every": 10,
              "mimi_config": {}, "num_codebooks": 8,
              "optimizer": {"lr": 1e-4, "grad_clip": 1.0}}
TRAIN_RESUME_BOUND = 1e-2
TRAIN_DIR = ROOT / "build" / "train"
# (d): the step-0 gradient of every adapter over two ranks (each its row of
# the batch, 256 rows a linear, the CE divided by the global count, the
# gradients all-reduced) against (a2)'s one-rank step at 512 rows,
# ||g_dp - g_1|| / ||g_1||, and the losses' relative difference (stated
# before the first card run, PERF.md §6): each row's forward and backward
# is the same arithmetic on the same kernels (int8_wgmma computes a row of a
# 128-row tile alone), so the two differ by the order of the sums over rows
# only (the weight gradients' reduction split in two halves, the CE's sum),
# which TRAIN_WITNESS_BOUND's 5e-2 bounds with room
TRAIN_MESH_BOUND = 5e-2
# ... and against the same one-rank step taken as two one-row halves (each
# row's gradient with its own CE mean, the two averaged, the rows' counts of
# valid positions being equal): the ranks run exactly those launches, and a
# CE divided by twice the count scales every backward value by 1/2, exactly,
# so the two differ by f32 rounding at most (stated after the first card
# run read 3.249e-2 against the whole batch, before this witness's first
# run: the whole batch's 512-row matmuls round otherwise than 256-row ones)
TRAIN_MESH_SPLIT_BOUND = 1e-4
TRAIN_MESH = {"world": 2, "steps": 2, "timeout": 300}
MESH_DIR = ROOT / "build" / "train_mesh"


@contextmanager
def plain_gemvs(f32: bool = False):
    """utils.matmul's q4_linear and int8_linear swapped for the plain
    versions (torch ops, differentiable as they are) while entered: in x's
    dtype (the weights dequantized to it first), or with `f32` on x and the
    weights in f32, the output cast to x's dtype (the kernels' arithmetic:
    exact weights, f32 sums, one rounding of the output)."""
    from moshi_tpu_torch.ops.q4matmul import q4_gemv_plain
    from moshi_tpu_torch.ops.qmatmul import int8_gemv_plain
    from moshi_tpu_torch.utils import matmul

    def plain(fn):
        def linear(x, q, scale):
            x2 = x.reshape(-1, x.shape[-1])
            y = fn(x2.float(), q, scale).to(x.dtype) if f32 else fn(x2, q, scale)
            return y.reshape(*x.shape[:-1], q.shape[-1])
        return linear
    saved = matmul.q4_linear, matmul.int8_linear
    matmul.q4_linear, matmul.int8_linear = plain(q4_gemv_plain), plain(int8_gemv_plain)
    try:
        yield
    finally:
        matmul.q4_linear, matmul.int8_linear = saved


@contextmanager
def dropped_base_gradient():
    """The kernels with the gradient through every frozen base dropped
    (their input detached): the silent failure the witness must see."""
    from moshi_tpu_torch.utils import matmul

    saved = matmul.q4_linear, matmul.int8_linear
    matmul.q4_linear, matmul.int8_linear = (
        (lambda x, q, scale, fn=fn: fn(x.detach(), q, scale)) for fn in saved)
    try:
        yield
    finally:
        matmul.q4_linear, matmul.int8_linear = saved


def grads_rel_err(got, want) -> float:
    """||got - want|| / ||want|| over every tensor of two lists."""
    num = sum(float((g.float() - w.float()).pow(2).sum()) for g, w in zip(got, want))
    den = sum(float(w.float().pow(2).sum()) for w in want)
    return (num / den) ** 0.5


def train_codes(lm, dev) -> torch.Tensor:
    """The seeded synthetic_repeat batch of train._data_batches."""
    from moshi_tpu_torch import train
    cfg = {"batch_size": TRAIN_LORA["batch"], "seq_len": TRAIN_LORA["frames"],
           "data": {"kind": "synthetic_repeat", "seed": SEED}}
    return torch.from_numpy(next(train._data_batches(cfg, "lm", lm, 1))).long().to(dev)


def lora_train(dev, card: str, lm, params, what: str, steps: int, per_step: dict,
               remat: bool) -> dict:
    """Adapters over `params`, the step-0 witness (the kernels against the
    plain GEMVs: loss, every adapter's gradient, a layer-0 adapter's), with
    remat the same step recomputed, then `steps` train steps: exact
    launches a step, s/step, frames/s, peak GiB, the frozen leaves byte
    for byte, the loss falling.  Returns the trained tree and the numbers."""
    from dataclasses import replace
    from moshi_tpu_torch import train
    from moshi_tpu_torch.models.lm import LMModel
    from moshi_tpu_torch.models.lora import replace_all_linear_with_lora

    g = torch.Generator(device=dev).manual_seed(SEED + 31)
    lp = replace_all_linear_with_lora(params, TRAIN_LORA["rank"], g, TRAIN_LORA["scaling"],
                                      torch.float32)
    opt = train.lora_optimizer(train.make_optimizer(TRAIN_OPT, steps), lp)
    paths = opt.select(lp)
    trained = set(paths)
    frozen = [(p, t.clone()) for p, t in train.tree_leaves(lp) if p not in trained]
    codes = train_codes(lm, dev)
    loss_fn = train.make_loss_fn(lm)
    expected = dict.fromkeys(counters(), 0)
    expected.update(per_step)

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    loss_k, _, g_k = train.value_and_grad(loss_fn, lp, paths, codes)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != expected:
        raise RuntimeError(f"{what}: one step's launches {launches}, expected {expected}")
    errs = {}
    for f32 in (False, True):
        with plain_gemvs(f32):
            zero_counts()
            loss_p, _, g_p = train.value_and_grad(loss_fn, lp, paths, codes)
            if any(read_counts().values()):
                raise RuntimeError(f"{what}: the plain witness launched kernels")
        errs["f32" if f32 else "bf16"] = grads_rel_err(g_k, g_p)
        if not f32:
            del g_p
    err = errs["f32"]
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    layer0 = paths.index(("transformer", "layers", "attn", "in_proj", "b"))
    g0k, g0p = g_k[layer0][0], g_p[layer0][0]
    g0_norm, g0_err = float(g0k.float().norm()), grads_rel_err([g0k], [g0p])
    with dropped_base_gradient():
        _, _, g_d = train.value_and_grad(loss_fn, lp, paths, codes)
    dropped = grads_rel_err(g_d, g_p)
    del g_p, g_d
    ok = (err <= TRAIN_WITNESS_BOUND and loss_err <= TRAIN_LOSS_BOUND and g0_norm > 0
          and dropped > TRAIN_WITNESS_BOUND
          and all(bool(torch.isfinite(t).all()) for t in g_k))
    n_adapter = sum(t.numel() for p, t in train.tree_leaves(lp) if p in trained)
    nonzero = {k: v for k, v in launches.items() if v}
    phase("train", f"{what}: {len(paths)} adapter leaves ({n_adapter / 1e6:.1f}M f32), one "
          f"step's launches {nonzero} over {codes.shape[0]} x "
          f"{codes.shape[2]} frames; witness against the plain GEMVs in f32: loss "
          f"{float(loss_k):.5f} vs {float(loss_p):.5f} (rel {loss_err:.2e}, bound "
          f"{TRAIN_LOSS_BOUND:.0e}), gradients ||diff|| / ||plain|| {err:.3e} (bound "
          f"{TRAIN_WITNESS_BOUND:.0e}; against the plain GEMVs in bf16 {errs['bf16']:.3e}; "
          f"with every base's backward dropped {dropped:.3e}); layer 0's in_proj b: ||g|| "
          f"{g0_norm:.3e}, rel err {g0_err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{what}: the kernels' gradient disagrees with the plain one's")
    res = {"adapter_leaves": len(paths), "launches_per_step": launches, "loss0": float(loss_k),
           "witness": {"grads_rel_err": err, "grads_rel_err_bf16_plain": errs["bf16"],
                       "grads_rel_err_base_backward_dropped": dropped,
                       "loss_rel_err": loss_err, "layer0_in_proj_b_norm": g0_norm,
                       "layer0_rel_err": g0_err},
           "step_peak_gib": peak}

    if remat:
        lm_r = LMModel(replace(lm.config, remat=True))
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        loss_r, _, g_r = train.value_and_grad(train.make_loss_fn(lm_r), lp, paths, codes)
        launches_r = read_counts()
        peak_r = torch.cuda.max_memory_allocated() / 2**30
        bitwise = torch.equal(loss_r, loss_k) and all(torch.equal(a, b) for a, b in zip(g_r, g_k))
        err_r = grads_rel_err(g_r, g_k)
        recompute = lm.config.num_layers * 4
        want_r = {**expected, "q4_wgmma": expected["q4_wgmma"] + recompute}
        ok = err_r <= TRAIN_REMAT_BOUND and launches_r == want_r
        phase("train", f"{what} with remat: launches {launches_r['q4_wgmma']} q4_wgmma (the "
              f"{recompute} temporal linears recomputed), loss and gradients "
              f"{'bit for bit equal' if bitwise else f'rel err {err_r:.3e}'} (bound "
              f"{TRAIN_REMAT_BOUND:.0e}); peak {peak_r:.2f} GiB against {peak:.2f} without "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{what}: remat gives other gradients or launches {launches_r}")
        res["remat"] = {"launches": launches_r, "bitwise": bitwise, "grads_rel_err": err_r,
                        "peak_gib": peak_r}
        del g_r
    del g_k

    state = opt.init(lp)
    step = train.make_train_step(lm, opt)
    losses, ms = [], []
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, state, loss, _ = step(lp, state, codes)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_counts(launches, expected, steps, what)
    same = all(torch.equal(train._get(lp, p), t) for p, t in frozen)
    frames = codes.shape[0] * codes.shape[2]
    s_step = float(np.median(ms[1:])) / 1e3
    ok = same and losses[-1] < losses[0] and all(np.isfinite(losses))
    phase("train", f"{what}: {steps} steps, losses {[round(v, 4) for v in losses]}; launches "
          f"{launches['q4_wgmma']} q4_wgmma, {launches['int8_wgmma']} int8_wgmma (per step x "
          f"{steps}); base and embeddings byte-equal: {same}; {s_step:.3f} s/step (median of "
          f"steps 2..), {frames / s_step:.0f} frames trained/s, peak {peak:.2f} GiB "
          f"{'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise RuntimeError(f"{what}: the frozen leaves changed or the loss did not fall")
    del frozen, state
    free_memory()
    res.update({"losses": losses, "step_ms": ms, "s_per_step": s_step,
                "frames_per_s": frames / s_step, "peak_gib": peak, "frozen_equal": same,
                "launches": launches})
    return lp, res


def lora_serves(dev, card: str, lm, lp) -> dict:
    """(b): LMGen at B = 1 over the trained LoRA tree, eager, each step's
    launches exactly 129 q4_gemv and 208 int8_mma; the fused tree in bf16
    against the LoRA tree: text logits of forward_text."""
    from moshi_tpu_torch.models.lm_gen import LMGen, LMGenConfig
    from moshi_tpu_torch.models.lora import fuse_lora_params

    cfg = lm.config
    expected = dict.fromkeys(counters(), 0)
    expected.update({"q4_gemv": sum(Q4_SHAPES.values()), "int8_mma": sum(INT8_SHAPES.values())})
    gen = LMGen(lm, LMGenConfig())
    state = gen.init_state(1, torch.Generator(device=dev).manual_seed(SEED + 32),
                           torch.bfloat16, dev)
    n_in = cfg.num_codebooks - cfg.dep_q - 1
    rs = np.random.RandomState(SEED + 33)
    outs, ms = [], []
    with torch.no_grad():
        for t in range(TRAIN_GEN_FRAMES):
            toks = torch.from_numpy(rs.randint(0, cfg.card, (1, n_in, 1))).to(dev)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, state = gen.step(lp, state, toks)
            outs.append(out.cpu())
            ms.append((time.perf_counter() - t0) * 1e3)
            check_counts(read_counts(), expected, 1, f"LoRA LMGen.step {t}")
        out = torch.cat(outs[cfg.max_delay:], dim=-1)
        check_tokens(out[0].T.numpy(), cfg, "LoRA LMGen")
        codes = train_codes(lm, dev)[:1, :, :TRAIN_FUSED_FRAMES]
        _, text_lora = lm.forward_text(lp, codes)
        fused = fuse_lora_params(lp)
        _, text_fused = lm.forward_text(fused, codes)
        del fused
    err = ((text_fused.float() - text_lora.float()).norm() / text_lora.float().norm()).item()
    ok = err <= TRAIN_FUSED_BOUND and bool(torch.isfinite(text_fused).all())
    phase("train", f"LoRA tree serves: LMGen B = 1, {TRAIN_GEN_FRAMES} eager frames, launches "
          f"a step {expected['q4_gemv']} q4_gemv + {expected['int8_mma']} int8_mma, p50 "
          f"{float(np.percentile(ms, 50)):.2f} ms/frame; fuse_lora_params in bf16 against the "
          f"LoRA tree over {TRAIN_FUSED_FRAMES} frames: text logits ||diff|| / ||LoRA|| "
          f"{err:.3e} (bound {TRAIN_FUSED_BOUND:.0e}) {'ok' if ok else 'FAIL'} ({card})")
    if not ok:
        raise RuntimeError("the fused LoRA tree's text logits disagree")
    free_memory()
    return {"launches": {k: v * TRAIN_GEN_FRAMES for k, v in expected.items()},
            "per_step": expected, "p50_ms": float(np.percentile(ms, 50)),
            "fused_text_logits_rel_err": err}


def train_cli(args: list) -> list:
    """`python -m moshi_tpu_torch.train ARGS` from the checkout's root:
    its JSON lines."""
    done = subprocess.run([sys.executable, "-m", "moshi_tpu_torch.train", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise RuntimeError(f"train CLI {args} exited {done.returncode}: {done.stderr[-3000:]}")
    return [json.loads(line) for line in done.stdout.splitlines() if line.startswith("{")]


def mimi_cli(dev, card: str) -> dict:
    """(c): Mimi v0.1 trained through the CLI (f32, 8 codebooks), saved at
    step 10; a second call resumes from it; the synced codec encodes."""
    from moshi_tpu_torch import train
    from moshi_tpu_torch.models.loaders import mimi_config_from_dict
    from moshi_tpu_torch.models.mimi import MimiModel

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    cfg = {"target": "mimi", "seed": SEED, "data": {"kind": "synthetic_repeat", "seed": SEED},
           "log_every": 1,
           "out_dir": str(TRAIN_DIR / "run"), "device": str(dev), **TRAIN_MIMI}
    (TRAIN_DIR / "mimi.json").write_text(json.dumps(cfg))
    t0 = time.perf_counter()
    run = train_cli(["--config", str(TRAIN_DIR / "mimi.json"), "--deterministic"])
    wall = time.perf_counter() - t0
    steps = [d for d in run if "step" in d and "loss" in d]
    at = TRAIN_MIMI["save_every"]
    resumed = train_cli(["--config", str(TRAIN_DIR / "mimi.json"), "--deterministic",
                         "--resume",
                         str(TRAIN_DIR / "run" / f"train-{at:06d}.safetensors"),
                         "--out-dir", str(TRAIN_DIR / "resumed")])
    first, last = steps[0], steps[-1]
    final, final_r = run[-1]["final_loss"], resumed[-1]["final_loss"]
    resume_err = abs(final_r - final) / abs(final)
    params, _, step, _ = train.load_train_state(
        TRAIN_DIR / "run" / f"train-{TRAIN_MIMI['steps']:06d}.safetensors", dev)
    mimi = MimiModel(mimi_config_from_dict(TRAIN_MIMI["mimi_config"],
                                           TRAIN_MIMI["num_codebooks"]))
    pcm = torch.from_numpy((0.1 * np.random.RandomState(SEED + 34).randn(
        1, 1, TRAIN_MIMI["seq_len"] * mimi.frame_size)).astype(np.float32)).to(dev)
    with torch.no_grad():
        codes = mimi.encode(params, pcm)
        audio = mimi.decode(params, codes)
    in_range = bool((codes >= 0).all() and (codes < mimi.cardinality).all())
    ok = (len(steps) == TRAIN_MIMI["steps"] and last["loss"] < first["loss"]
          and last["entropy"] > 0.5 and in_range and bool(torch.isfinite(audio).all())
          and resume_err <= TRAIN_RESUME_BOUND and step == TRAIN_MIMI["steps"])
    seconds = TRAIN_MIMI["seq_len"] * mimi.frame_size / mimi.config.sample_rate
    phase("train", f"Mimi f32 through `python -m moshi_tpu_torch.train` (B = "
          f"{TRAIN_MIMI['batch_size']} x {seconds:g} s): loss step 1 {first['loss']:.4f} -> step "
          f"{last['step']} {last['loss']:.4f}, entropy {last['entropy']:.3f} (> 0.5), codes "
          f"in [0, {mimi.cardinality}): {in_range}; resumed at step {at} (both calls "
          f"--deterministic): final loss {final_r:.6f} vs {final:.6f} uninterrupted "
          f"({'bit for bit' if final_r == final else 'not bit for bit'}; rel "
          f"{resume_err:.2e}, bound "
          f"{TRAIN_RESUME_BOUND:.0e}); {last['sec_per_step']:.3f} s/step, peak "
          f"{last.get('peak_gib', float('nan')):.2f} GiB, the call {wall:.1f} s "
          f"{'ok' if ok else 'FAIL'} ({card})")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if not ok:
        raise RuntimeError("Mimi training through the CLI failed its checks")
    return {"loss_first": first["loss"], "loss_last": last["loss"],
            "entropy": last["entropy"], "resumed_final_loss": final_r, "final_loss": final,
            "deterministic": True, "resume_bitwise": final_r == final,
            "resume_rel_err": resume_err, "s_per_step": last["sec_per_step"],
            "peak_gib": last.get("peak_gib"), "call_s": wall}


def mesh_train_config(out_dir=None, **over) -> dict:
    """(d)/(e)'s config: (a2)'s LoRA tree from MESH_DIR's checkpoint, its
    seeded codes, TRAIN_MESH["steps"] steps of TRAIN_OPT."""
    return {"target": "lm", "checkpoint_dir": str(MESH_DIR / "ckpt"), "lora_only": True,
            "optimizer": TRAIN_OPT, "steps": TRAIN_MESH["steps"],
            "batch_size": TRAIN_LORA["batch"], "seq_len": TRAIN_LORA["frames"],
            "data": {"kind": "synthetic_repeat", "seed": SEED}, "log_every": 1,
            "seed": SEED, "out_dir": out_dir, **over}


def mesh_rank(rank: int) -> None:
    """One rank of (d), run as `chip_smoke.py --mesh-rank RANK`: a gloo
    group of TRAIN_MESH["world"] processes on cuda:0 through a file store in
    MESH_DIR; for dp and then fsdp the step-0 witness (rank 0 holds it
    against (a2)'s gradient) and TRAIN_MESH["steps"] steps through
    run_training; each int8 linear's rows recorded.  Writes
    MESH_DIR/rank{RANK}.json."""
    import torch.distributed as dist
    from moshi_tpu_torch import train
    from moshi_tpu_torch.models import native_ckpt
    from moshi_tpu_torch.models.loaders import CheckpointInfo
    from moshi_tpu_torch.parallel import collectives
    from moshi_tpu_torch.parallel.mesh import make_mesh
    from moshi_tpu_torch.utils import matmul

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{MESH_DIR / 'store'}", rank=rank,
                            world_size=TRAIN_MESH["world"])
    rows = []
    int8_linear = matmul.int8_linear

    def recorded(x, q, scale):
        rows.append(x.numel() // x.shape[-1])
        return int8_linear(x, q, scale)
    matmul.int8_linear = recorded
    cfg = mesh_train_config()
    out = {}
    try:
        for mode in ("dp", "fsdp"):
            fsdp = mode == "fsdp"
            lm, params = CheckpointInfo.from_dir(cfg["checkpoint_dir"]).get_moshi(
                dtype=torch.float32, device=dev)
            paths = train.lora_optimizer(train.make_optimizer({}), params).select(params)
            dp = train.DataParallel(make_mesh(TRAIN_MESH["world"], tp=1), params, paths, fsdp)
            kept = dp.shard(params)
            del params
            codes = torch.from_numpy(dp.rows(next(train._data_batches(cfg, "lm", lm, 1)))
                                     ).long().to(dev)
            whole = dp.gather(kept)
            zero_counts()
            rows.clear()
            loss, _, grads = train.value_and_grad(train.make_loss_fn(lm, dp.group), whole,
                                                  paths, codes)
            witness_launches, witness_rows = read_counts(), sorted(set(rows))
            del whole, kept
            grads = dp.reduce(grads)
            loss = float(dp.total(loss))
            grads = [g if d is None else collectives.all_gather(g, d, dp.group)
                     for g, d in zip(grads, dp.grad_dims)]
            res = {"loss0": loss, "witness_launches": witness_launches,
                   "witness_rows": witness_rows}
            if rank == 0:
                ref = native_ckpt.load_params(MESH_DIR / "step0.safetensors", dev)
                res["grads_rel_err"] = grads_rel_err(grads, ref["grads"])
                res["grads_rel_err_split"] = grads_rel_err(grads, ref["grads_split"])
                res["loss_rel_err"] = abs(loss - float(ref["loss"])) / abs(float(ref["loss"]))
                del ref
            del grads
            free_memory()
            lines = []
            zero_counts()
            rows.clear()
            run = train.run_training({**cfg, "mesh": {"dp": TRAIN_MESH["world"], "fsdp": fsdp}},
                                     log=lambda line: lines.append(json.loads(line)), device=dev)
            steps = [d for d in lines if "sec_per_step" in d]
            resident = sum(t.numel() * t.element_size() for tree in ("params", "opt_state")
                           for _, t in train.tree_leaves(run[tree]))
            res.update({"launches": read_counts(), "rows": sorted(set(rows)),
                        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                        "resident_gib": resident / 2**30, "losses": [d["loss"] for d in steps],
                        "final_loss": run["loss"],
                        "sec_per_step": [d["sec_per_step"] for d in steps],
                        "gloo_note": any(d.get("event") == "mesh" for d in lines)})
            del run
            free_memory()
            out[mode] = res
    finally:
        matmul.int8_linear = int8_linear
        dist.destroy_process_group()
    (MESH_DIR / f"rank{rank}.json").write_text(json.dumps(out))


def train_mesh(dev, card: str, lm8, params8) -> dict:
    """(d) two ranks on the one card and (e) the torchrun CLI at world size
    1, over (a2)'s int8 tree with its fresh adapters."""
    from dataclasses import asdict
    from moshi_tpu_torch import train
    from moshi_tpu_torch.models import native_ckpt
    from moshi_tpu_torch.models.lora import replace_all_linear_with_lora

    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    (MESH_DIR / "ckpt").mkdir(parents=True)
    try:
        lp = replace_all_linear_with_lora(params8, TRAIN_LORA["rank"],
                                          torch.Generator(device=dev).manual_seed(SEED + 31),
                                          TRAIN_LORA["scaling"], torch.float32)
        (MESH_DIR / "ckpt" / "config.json").write_text(json.dumps(
            {**asdict(lm8.config), "native_format": True, "moshi_name": "m.safetensors"}))
        native_ckpt.save_params(MESH_DIR / "ckpt" / "m.safetensors", lp)
        # (a2)'s one-rank step 0 on the global batch, for the ranks' witness
        paths = train.lora_optimizer(train.make_optimizer({}), lp).select(lp)
        codes = train_codes(lm8, dev)
        loss_fn = train.make_loss_fn(lm8)
        loss1, _, g1 = train.value_and_grad(loss_fn, lp, paths, codes)
        halves = [train.value_and_grad(loss_fn, lp, paths, codes[i:i + 1])[2]
                  for i in range(codes.shape[0])]
        split = [(a + b) / 2 for a, b in zip(*halves)]
        native_ckpt.save_params(MESH_DIR / "step0.safetensors",
                                {"loss": loss1, "grads": g1, "grads_split": split})
        del halves, split, lp, g1
        free_memory()
        t_setup = time.perf_counter() - t0

        t1 = time.perf_counter()
        logs = [MESH_DIR / f"rank{r}.log" for r in range(TRAIN_MESH["world"])]
        with ExitStack() as files:
            procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                       "--mesh-rank", str(r)], cwd=ROOT,
                                      stdout=files.enter_context(open(log, "w")),
                                      stderr=subprocess.STDOUT)
                     for r, log in enumerate(logs)]
            try:
                rcs = [p.wait(timeout=TRAIN_MESH["timeout"]) for p in procs]
            finally:
                for p in procs:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise RuntimeError("(d) a rank failed: "
                               + "\n".join(log.read_text()[-3000:] for log in logs))
        ranks = [json.loads((MESH_DIR / f"rank{r}.json").read_text())
                 for r in range(TRAIN_MESH["world"])]
        t_d = time.perf_counter() - t1

        per_step = 4 * lm8.config.num_layers + 1
        rows = TRAIN_LORA["frames"] * TRAIN_LORA["batch"] // TRAIN_MESH["world"]
        res = {}
        for mode in ("dp", "fsdp"):
            rk = [r[mode] for r in ranks]
            w = rk[0]
            ok = (w["grads_rel_err"] <= TRAIN_MESH_BOUND and w["loss_rel_err"] <= TRAIN_LOSS_BOUND
                  and w["grads_rel_err_split"] <= TRAIN_MESH_SPLIT_BOUND
                  and all(r["witness_launches"]["int8_wgmma"] == per_step
                          and r["launches"]["int8_wgmma"] == per_step * TRAIN_MESH["steps"]
                          and sum(r["launches"].values()) == r["launches"]["int8_wgmma"]
                          and r["rows"] == [rows] and r["witness_rows"] == [rows]
                          for r in rk)
                  and len(w["losses"]) == TRAIN_MESH["steps"] and all(np.isfinite(w["losses"]))
                  and rk[0]["final_loss"] == rk[1]["final_loss"] == w["losses"][-1]
                  and w["gloo_note"])
            # the log's sec_per_step is the mean since the first step
            done = [v * (i + 1) for i, v in enumerate(w["sec_per_step"])]
            step_s = [b - a for a, b in zip([0.0] + done[:-1], done)]
            phase("train", f"(d) mesh {{dp: 2{', fsdp: true' if mode == 'fsdp' else ''}}}, two "
                  f"ranks sharing the one card (gloo: the collectives' CUDA tensors go "
                  f"through host memory): step-0 loss {w['loss0']:.5f} (rel "
                  f"{w['loss_rel_err']:.2e} against one rank, bound {TRAIN_LOSS_BOUND:.0e}), "
                  f"all-reduced adapter gradients ||g_dp - g_1|| / ||g_1|| "
                  f"{w['grads_rel_err']:.3e} (bound {TRAIN_MESH_BOUND:.0e}), against the same "
                  f"step as two one-row halves {w['grads_rel_err_split']:.3e} (bound "
                  f"{TRAIN_MESH_SPLIT_BOUND:.0e}); "
                  f"{TRAIN_MESH['steps']} steps through run_training: losses "
                  f"{[round(v, 4) for v in w['losses']]}, int8_wgmma per rank "
                  f"{[r['launches']['int8_wgmma'] for r in rk]} ({per_step} a step of "
                  f"{rk[0]['rows']} rows), s/step {[round(v, 3) for v in step_s]}, peak GiB "
                  f"per rank {[round(r['peak_gib'], 2) for r in rk]}, resident GiB of params "
                  f"and optimizer state per rank {[round(r['resident_gib'], 3) for r in rk]} "
                  f"{'ok' if ok else 'FAIL'} ({card})")
            if not ok:
                raise RuntimeError(f"(d) {mode}: {rk}")
            res[mode] = {"ranks": rk, "s_per_step": step_s}
        res["fsdp_resident_share"] = (res["fsdp"]["ranks"][0]["resident_gib"]
                                      / res["dp"]["ranks"][0]["resident_gib"])
        res["d_s"] = t_d

        # (e): torchrun at world size 1 (NCCL) against the plain CLI
        t2 = time.perf_counter()
        for name, over in (("torchrun", {"mesh": {"dp": 1}}), ("plain", {})):
            (MESH_DIR / f"{name}.json").write_text(json.dumps(mesh_train_config(
                str(MESH_DIR / name), device="cuda", **over)))
        launcher = {"torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                                 "--nproc_per_node", "1"], "plain": [sys.executable]}
        with ExitStack() as files:
            procs = {name: subprocess.Popen(
                [*cmd, "-m", "moshi_tpu_torch.train", "--config", str(MESH_DIR / f"{name}.json"),
                 "--deterministic"], cwd=ROOT,
                stdout=files.enter_context(open(MESH_DIR / f"{name}.log", "w")),
                stderr=subprocess.STDOUT) for name, cmd in launcher.items()}
            try:
                rcs = {name: p.wait(timeout=TRAIN_MESH["timeout"]) for name, p in procs.items()}
            finally:
                for p in procs.values():
                    p.kill()
                    p.wait()
        runs = {name: (MESH_DIR / f"{name}.log").read_text() for name in procs}
        for name, rc in rcs.items():
            if rc:
                raise RuntimeError(f"(e) {name} exited {rc}: {runs[name][-3000:]}")
        at = f"train-{TRAIN_MESH['steps']:06d}.safetensors"
        a, b = (train.load_train_state(MESH_DIR / name / at)[0] for name in ("torchrun", "plain"))
        la, lb = list(train.tree_leaves(a)), list(train.tree_leaves(b))
        equal = [p for p, _ in la] == [p for p, _ in lb] and all(
            x.dtype == y.dtype and x.shape == y.shape
            and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
            for (_, x), (_, y) in zip(la, lb))
        finals = {name: [json.loads(line) for line in runs[name].splitlines()
                         if line.startswith('{"final_step"')] for name in runs}
        del a, b, la, lb
        t_e = time.perf_counter() - t2
        ok = equal and all(len(v) == 1 for v in finals.values())
        phase("train", f"(e) `torch.distributed.run --standalone --nproc_per_node 1 -m "
              f"moshi_tpu_torch.train` with mesh {{dp: 1}} (NCCL, world size 1) against the "
              f"plain CLI, {TRAIN_MESH['steps']} steps each with --deterministic: final loss "
              f"{finals['torchrun'][0]['final_loss'] if finals['torchrun'] else None} vs "
              f"{finals['plain'][0]['final_loss'] if finals['plain'] else None}, saved params "
              f"byte for byte equal: {equal}; (d) {t_d:.1f} s, (e) {t_e:.1f} s, setup "
              f"{t_setup:.1f} s {'ok' if ok else 'FAIL'} ({card})")
        if not ok:
            raise RuntimeError("(e) the torchrun run's params differ from the plain CLI's")
        res.update({"e_bytewise_equal": equal, "e_s": t_e, "setup_s": t_setup,
                    "phase_s": time.perf_counter() - t0})
        return res
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)


def run_train(dev, card: str, lm, lm_params) -> dict:
    """[train]: (a) LoRA over the q4/int8 Moshi-7B weights, with remat;
    (a2) the same over int8 serving weights at cut depth; (b) the trained
    tree served by LMGen and fused; (d) (a2)'s tree over two ranks and (e)
    through torchrun; (c) Mimi through the CLI."""
    from dataclasses import replace
    from moshi_tpu_torch.models.lm import LMModel
    from moshi_tpu_torch.utils.quantize import quantize_lm_params

    t0 = time.perf_counter()
    rows = TRAIN_LORA["batch"] * TRAIN_LORA["frames"]
    per_step = {"q4_wgmma": sum(Q4_SHAPES.values())}
    lp, res = lora_train(dev, card, lm, lm_params, "LoRA over Moshi-7B q4/int8",
                         TRAIN_LORA["steps"], per_step, remat=True)
    res["serve"] = lora_serves(dev, card, lm, lp)
    del lp
    free_memory()

    cfg8 = replace(lm.config, num_layers=TRAIN_INT8["layers"])
    lm8 = LMModel(cfg8)
    g = torch.Generator(device=dev).manual_seed(SEED + 35)
    params8 = quantize_lm_params(lm8.init_params(g, torch.bfloat16, dev), mode="int8")
    free_memory()
    per_step8 = {"int8_wgmma": 4 * cfg8.num_layers + 1}   # one launch of B * T rows each
    _, res8 = lora_train(dev, card, lm8, params8,
                         f"LoRA over Moshi-7B int8 ({cfg8.num_layers} layers)",
                         TRAIN_INT8["steps"], per_step8, remat=False)
    free_memory()
    res["mesh"] = train_mesh(dev, card, lm8, params8)
    del params8
    free_memory()
    res["int8_base"] = res8
    res["mimi"] = mimi_cli(dev, card)
    res["phase_s"] = time.perf_counter() - t0
    phase("train", f"the phase took {res['phase_s']:.1f} s")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch sees no CUDA device")
    import moshi_tpu_torch  # noqa: F401  (pins TF32 off)
    from moshi_tpu_torch.ops import build

    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    phase("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build_all(extra_flags=("-Xptxas", "-v"))
    for name in build.SIGNATURES:
        build.load(name)
    phase("build", f"{', '.join(build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc in parallel: {build.build_seconds or 'libraries already built'}) -> "
          f"{build.BUILD_DIR}")
    for name, log in logs.items():
        regs, spills = ptxas_summary(log)
        phase("build", f"{name}: max {regs} registers, {spills} bytes of spill stores")
        if spills:
            raise RuntimeError(f"{name} spills registers")

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    gemvs = check_gemvs(dev, g)
    attn = check_attention(dev, g)
    write = check_fused_write(dev, g)
    # K4's row: the launch of the main path, the write included
    attn["per_launch"] = {**attn["per_launch"], **write["k4_per_launch"]}
    attn8 = check_attention_int8(dev, g)
    tts_gemvs = check_tts_gemvs(dev, g)
    offline_q4 = check_offline_q4(dev, g)
    int8_rows = check_int8_rows(dev, g)
    tts_rows = check_tts_rows(dev, g)
    hibiki_gemvs = check_hibiki_gemvs(dev, g)
    helium_q4 = check_helium_q4(dev, g)
    free_memory()
    phase("kernels", f"the phase took {time.perf_counter() - t0:.1f} s")

    lm, lm_params, mimi, mimi_params = build_models(dev)
    slice_ = run_slice(dev, card, lm, lm_params, mimi, mimi_params)
    free_memory()
    serve = run_serve(dev, card, lm, lm_params, mimi, mimi_params, slice_["p50_ms"])
    free_memory()
    batched = run_batched(dev, card, lm_params, mimi, mimi_params)
    free_memory()
    offline = run_offline(dev, card, lm, lm_params, mimi, mimi_params)
    del mimi, mimi_params
    free_memory()
    configs = {"prefill": configs_prefill(dev, card, lm, lm_params),
               "mimi": configs_mimi(dev, card)}
    train = run_train(dev, card, lm, lm_params)
    del lm, lm_params
    free_memory()
    hibiki = run_hibiki(dev, card)
    helium = run_helium(dev, card)
    bench_cli = run_bench_cli(dev, card, slice_["p50_ms"])
    asr = run_asr(dev, card)
    free_memory()
    stt = run_stt(dev, card)
    try:
        worker = run_worker(dev, card, serve, batched["greedy"]["p50_ms"])
        free_memory()
        fleet = run_fleet(dev, card, serve, worker)
    finally:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
        shutil.rmtree(ASR_DIR, ignore_errors=True)
    free_memory()
    try:
        tts = run_tts(dev, card)   # writes TTS_DIR at its end
        free_memory()
        tts_serve = run_tts_serve(dev, card, tts)
    finally:
        shutil.rmtree(TTS_DIR, ignore_errors=True)

    # the main paths' runs, all graphed: their launches counted at capture
    # (the offline forward is not graphed: its launches are one eager call's)
    by_path = {"slice_b1": slice_["launches"], "serve": serve["launches"],
               **{f"batched_{p}": v for p, v in batched["launches"].items()},
               "offline_forward": offline["launches"],
               "hibiki": hibiki["launches"], "asr": asr["launches"], "stt": stt["launches"],
               "worker": worker["launches"], "fleet": fleet["launches"],
               "py_basr": fleet["py_basr"]["launches"], **tts["launches"],
               "tts_serve": tts_serve["launches"], "train_lora": train["launches"],
               "train_int8_base": train["int8_base"]["launches"],
               **{f"train_mesh_{m}": {k: sum(r["launches"][k] for r in train["mesh"][m]["ranks"])
                                      for k in counters()} for m in ("dp", "fsdp")},
               "train_lmgen": train["serve"]["launches"], **helium["launches"],
               **bench_cli["launches"],
               **{f"configs_prefill_{kv}": v["launches"] for kv, v in configs["prefill"].items()}}
    per_frame_by_path = {"batched": batched["per_frame"]["int4"],
                         "batched_int8": batched["per_frame"]["int8"],
                         "offline_forward": offline["launches"], "asr": asr["per_frame"],
                         **{f"worker_{m}": v for m, v in worker["per_frame"].items()},
                         "fleet": fleet["per_step"], "fleet_vision": fleet["vision_per_step"],
                         "py_basr": fleet["py_basr"]["per_frame"],
                         **tts["per_frame"], **hibiki["per_step"], "stt": stt["per_step"],
                         "train_step": train["launches_per_step"],
                         "train_int8_step": train["int8_base"]["launches_per_step"],
                         "train_mesh_rank_step": {
                             k: v // TRAIN_MESH["steps"]
                             for k, v in train["mesh"]["dp"]["ranks"][0]["launches"].items()},
                         "train_lmgen": train["serve"]["per_step"], **helium["per_step"],
                         **bench_cli["per_step"]}
    kernels = []
    # ms / plain_ms / library_ms / bound_ms: card time of one frame's
    # launches of the kernel (bf16, operands cold in L2) on the path it
    # runs, from the per-shape (GEMVs) or per-launch times: the B = 1 frame
    # for the q4_gemv kernel, a B = 16 batched frame for q4_mma, int8_mma,
    # decode_attention_int4 (the fused launch) and cache_write_int4 (the
    # fused launch's time over the attention alone), a B = 256 ASR frame for
    # decode_attention_int8, one offline forward (M = 256) for q4_wgmma
    # (int8_gemv: Moshi's depformer linears at B = 16,
    # as int8_mma, though only the TTS heads launch it on a path); the
    # 32-row TTS frame ([configs] (b)) for int8_wgmma;
    # "per_frame_by_batch" has the GEMVs' Moshi frames at each batch timed,
    # "tts" / "tts_per_frame" the TTS frame's launches
    for k in gemvs:
        main_b = 1 if k["name"] == "q4_gemv" else SLOTS
        row = {**k["per_frame"][main_b], "per_frame_by_batch": k["per_frame"],
               **{key: v for key, v in k.items() if key != "per_frame"}}
        if k["name"] in tts_gemvs:
            row["tts"] = tts_gemvs[k["name"]]
        if k["name"] in hibiki_gemvs:
            row["hibiki"] = hibiki_gemvs[k["name"]]
        if k["name"] == "q4_gemv":
            row["helium_profiled_ms_per_step"] = helium["profile"]["q4_gemv_ms_per_step"]
        if k["name"] == "int8_gemv":
            row["tts_rows_32"] = tts_rows["int8_gemv"]
        kernels.append(row)
    # int8_wgmma: the 32-row TTS frame's launches ([configs] (b)), the
    # depformer's linears at INT8_ROWS and the 16-row chunks it replaced beside
    wg8 = tts_rows["int8_wgmma"]
    kernels.append({"name": "int8_wgmma", **wg8["per_frame"], "bound_by": wg8["bound_by"],
                    "max_abs_err": max(wg8["max_abs_err"], int8_rows["max_abs_err"]),
                    "tts_rows_32": wg8, "depformer_rows": int8_rows})
    # q4_wgmma: the offline forward's launches at M = 256 (OFFLINE_LM's
    # B * T), the other row counts timed and the crossover beside them
    kernels.append({"name": "q4_wgmma", **offline_q4["per_forward"][256],
                    "per_forward_by_rows": offline_q4["per_forward"],
                    "helium_prefill": helium_q4,
                    **{key: v for key, v in offline_q4.items() if key != "per_forward"}})
    tts_per_launch = {"decode_attention_int4": write["tts_k4_per_launch"],
                      "cache_write_int4": write["tts_per_launch"],
                      "decode_attention_int8": attn8["per_launch_by_shape"]["tts"]}
    for name, k, path in (("decode_attention_int4", attn, "batched"),
                          ("cache_write_int4", write, "batched"),
                          ("decode_attention_int8", attn8, "asr")):
        n = per_frame_by_path[path][name]
        n_tts = per_frame_by_path["tts" if name != "decode_attention_int8" else "tts_int8"][name]
        kernels.append({"name": name, **{key: v * n for key, v in k["per_launch"].items()},
                        **k, "tts_per_frame": {key: v * n_tts for key, v
                                               in tts_per_launch[name].items()}})
    for k in kernels:
        name = k["name"]
        if name == "cache_write_int4":
            k["runs_in"] = "decode_attention_int4's launch"
        k.update({"route": "cuda", "source": SOURCES[name], "replaces": TPU_KERNELS[name],
                  "launches": sum(v[name] for v in by_path.values()),
                  "launches_by_path": {p: v[name] for p, v in by_path.items()},
                  "launches_per_frame": {p: v[name] for p, v in per_frame_by_path.items()}})
    phase("done", f"every phase in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels, "slice": slice_,
                      "serve": {key: v for key, v in serve.items()
                                if key not in ("launches", "greedy_tokens")},
                      "worker": {key: v for key, v in worker.items()
                                 if key not in ("launches", "per_frame")},
                      "fleet": {"migration": fleet["migration"], "vision": fleet["vision"],
                                "py_basr": {key: v for key, v in fleet["py_basr"].items()
                                            if key not in ("launches", "per_frame")},
                                "phase_s": fleet["phase_s"]},
                      "batched": {key: batched[key] for key in ("sampled", "sampled_eager",
                                                                "greedy", "int8_greedy")},
                      "offline": {key: v for key, v in offline.items() if key != "launches"},
                      "hibiki": {key: v for key, v in hibiki.items()
                                 if key not in ("launches", "per_step")},
                      "asr": {key: v for key, v in asr.items()
                              if key not in ("launches", "per_frame")},
                      "stt": {key: v for key, v in stt.items()
                              if key not in ("launches", "per_step")},
                      "tts": {key: v for key, v in tts.items()
                              if key not in ("launches", "per_frame", "checkpoint", "configs")},
                      "configs": {**configs, "tts": tts["configs"]},
                      "tts_serve": {key: v for key, v in tts_serve.items()
                                    if key != "launches"},
                      "train": train, "helium": {key: v for key, v in helium.items()
                                                 if key not in ("launches", "per_step")},
                      "bench_cli": {key: bench_cli[key] for key in ("runs", "phase_s")}}),
          flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(int(sys.argv[2]))
    else:
        main()
