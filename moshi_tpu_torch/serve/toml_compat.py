"""Reference moshi-server worker TOMLs, read verbatim (counterpart of
moshi_tpu/serve/toml_compat.py).

The rust production worker's schema (`rust/moshi-server/src/main.rs:
71-277`) differs from the native one in three ways:

1. module type tags are serde CamelCase variants:
   `type = "Lm" | "Asr" | "BatchedAsr" | "PyBatchedAsr" | "Mimi" | "Tts" |
   "Py" | "PyPost"` (main.rs:154-196);
2. routes are `path` (Mimi: `send_path` / `recv_path`);
3. model files are explicit (`lm_model_file`, `text_tokenizer_file`,
   `audio_tokenizer_file`) and the whole model architecture rides inline:
   a `[modules.X.model]` table deserialized into `moshi::lm::Config`, plus
   a `gen` / `generation` table for the runtime config.

`translate_module` maps each reference module onto the native schema:
the tag to the native type, `path` to `route`, and the inline schema to a
config.json dict (models/rust_config.py) carried under `_inline`, which
`inline_checkpoint_info` turns into a CheckpointInfo over the explicit
files.  The dicts equal the JAX package's.
"""

from __future__ import annotations

from pathlib import Path

from ..models.rust_config import lm_config_dict_from_rust, translate_conditioners

# main.rs:154-196 ModuleConfig variants -> native worker types
REFERENCE_TYPES = {
    "Lm": "moshi",
    "Asr": "asr",
    "BatchedAsr": "batched_asr",
    "PyBatchedAsr": "py_batched_asr",
    "Mimi": "mimi",
    "Tts": "tts",
    "Py": "py",
    "PyPost": "py_post",
}

FRAME_RATE = 12.5  # tokens/s of every mimi-era checkpoint


def is_reference_module(mcfg: dict) -> bool:
    return mcfg.get("type") in REFERENCE_TYPES


def _config_json(m: dict, model_type: str, gen: dict | None = None,
                 extra: dict | None = None) -> dict:
    """Inline rust `model` table (+ gen) -> a config.json-style dict (the
    schema `CheckpointInfo`/`LmConfig.from_dict` already consume)."""
    model = dict(m.get("model") or {})
    conditioners = translate_conditioners(model.pop("conditioners", None))
    cfg = lm_config_dict_from_rust(model, gen=gen)
    if cfg.get("depformer_weights_per_step_schedule") is not None:
        cfg["depformer_weights_per_step_schedule"] = list(
            cfg["depformer_weights_per_step_schedule"])
    if conditioners:
        cfg["conditioners"] = conditioners
    cfg["model_type"] = model_type
    cfg.update(extra or {})
    return cfg


def translate_module(name: str, m: dict) -> dict:
    """One reference `[modules.X]` table -> the native worker mcfg."""
    m = dict(m)
    rtype = m.pop("type")
    ntype = REFERENCE_TYPES[rtype]
    out = {"type": ntype}

    if rtype == "Mimi":
        # mimi.rs broadcast rooms: producer socket on send_path, listeners
        # on recv_path; the native module mounts rooms under the route
        out["route"] = m["send_path"]
        out["recv_route"] = m.get("recv_path")
        out["_inline"] = {"paths": {"mimi": m["audio_tokenizer_file"]},
                          "config": {}}
        for k in ("rooms", "default_room", "auth_recv"):
            if k in m:
                out[k] = m[k]
        return out

    out["route"] = m.pop("path", None) or m.pop("route")

    if rtype in ("Py", "PyPost"):
        # py_module.rs / py_module_post.rs: user script + `py` table
        if "script" in m:
            out["script"] = m["script"]
        out["batch_size"] = m.get("batch_size", 1)
        cfg = dict(m.get("py") or {})
        for k in ("text_tokenizer_file", "text_bos_token"):
            if k in m:
                cfg[k] = m[k]
        out["config"] = cfg
        return out

    if rtype == "PyBatchedAsr":
        # py_basr_module.rs: user-python batched ASR, bitmask step protocol
        if "script" in m:
            out["script"] = m["script"]
        out["batch_size"] = m["batch_size"]
        out["text_tokenizer_file"] = m["text_tokenizer_file"]
        out["asr_delay_in_tokens"] = m["asr_delay_in_tokens"]
        out["config"] = dict(m.get("py") or {})
        return out

    if rtype in ("Asr", "BatchedAsr"):
        # main.rs:84-103 AsrConfig (+ batch_size for the batched variant)
        stt = {"audio_delay_seconds":
               int(m["asr_delay_in_tokens"]) / FRAME_RATE}
        if m.get("conditioning_delay") is not None:
            stt["conditioning_delay"] = m["conditioning_delay"]
        cfg = _config_json(m, "stt", extra={"stt_config": stt})
        out["_inline"] = {"paths": _model_paths(m), "config": cfg}
        out["asr_delay_in_tokens"] = int(m["asr_delay_in_tokens"])
        for src, dst in (("temperature", "temperature"),
                         ("conditioning_delay", "conditioning_delay"),
                         ("conditioning_learnt_padding",
                          "conditioning_learnt_padding"),
                         ("batch_size", "batch_size")):
            if src in m:
                out[dst] = m[src]
        return _with_knobs(out, m)

    if rtype == "Lm":
        # main.rs:123-132 LmConfig: full-duplex moshi + `gen` runtime table
        cfg = _config_json(m, "moshi", gen=m.get("gen"))
        out["_inline"] = {"paths": _model_paths(m), "config": cfg}
        return _with_knobs(out, m)

    if rtype == "Tts":
        # main.rs:71-83 TtsConfig: voices + tts_streaming `generation` table
        gen = dict(m.get("generation") or {})
        tts_cfg = {}
        if "text_audio_delay_in_tokens" in gen:
            tts_cfg["audio_delay"] = \
                int(gen["text_audio_delay_in_tokens"]) / FRAME_RATE
        if "second_stream_ahead" in gen:
            tts_cfg["second_stream_ahead"] = gen["second_stream_ahead"]
        if "speaker_cond_n_speakers" in gen:
            tts_cfg["max_speakers"] = gen["speaker_cond_n_speakers"]
        cfg = _config_json(m, "tts", gen=gen,
                           extra={"tts_config": tts_cfg})
        paths = _model_paths(m)
        out["_inline"] = {"paths": paths, "config": cfg}
        if "max_consecutive_pads" in gen:
            out["max_padding"] = int(gen["max_consecutive_pads"])
        if "voice_dir" in m:
            out["voice_dir"] = m["voice_dir"]
        if "voices" in m:
            out["voices"] = dict(m["voices"])
        if "speaker_tokenizer_file" in m:
            out["speaker_tokenizer_file"] = m["speaker_tokenizer_file"]
        for k in ("batch_size", "temp", "cfg_coef", "n_q"):
            if k in m:
                out[k] = m[k]
        return _with_knobs(out, m)

    raise ValueError(f"module {name}: unhandled reference type {rtype}")


def _model_paths(m: dict) -> dict:
    paths = {"moshi": m["lm_model_file"],
             "tokenizer": m["text_tokenizer_file"]}
    if "audio_tokenizer_file" in m:
        paths["mimi"] = m["audio_tokenizer_file"]
    return paths


def _with_knobs(out: dict, m: dict) -> dict:
    # native capacity knobs are accepted inside reference-schema modules too
    for k in ("kv_cache", "context", "weights", "mimi_dtype", "tp",
              "log_dir", "cfg_coef", "vault_url", "fleet_auth",
              "replicate_every"):
        if k in m:
            out[k] = m[k]
    # rust dtype_override: "bf16"/"f16"/"f32" for the LM weights; bf16 is
    # already the native load dtype, quantized modes map to the weights knob
    dt = m.get("dtype_override")
    if dt in ("q8", "int8"):
        out["weights"] = "int8"
    elif dt in ("q4", "int4"):
        out["weights"] = "int4"
    return out


def inline_checkpoint_info(inline: dict):
    """A CheckpointInfo over explicit per-file paths, each a local path or
    `hf://repo/file` (the reference worker's resolution, main.rs:211-277).

    The rust schema never describes the Mimi architecture (the rust worker
    hardcodes the standard one); another Mimi is described by a
    `mimi_config.json` beside the audio tokenizer's weights."""
    from ..models.loaders import CheckpointInfo, hf_get

    paths = {k: hf_get(v) for k, v in inline["paths"].items()}
    if "mimi" in paths and "mimi_config" not in paths:
        side = Path(paths["mimi"]).parent / "mimi_config.json"
        if side.exists():
            paths["mimi_config"] = side
    cfg = dict(inline.get("config") or {})
    # mimi-only modules carry no LM config at all
    return CheckpointInfo(cfg or None, paths=paths)


def translate_config(cfg: dict) -> dict:
    """Whole worker TOML: translate every reference-schema module in place;
    native modules pass through untouched.  Reference top-level keys
    (static_dir/log_dir/instance_name/authorized_ids) already share names
    with the native schema."""
    out = dict(cfg)
    modules = {}
    for name, m in dict(cfg.get("modules", {})).items():
        modules[name] = translate_module(name, m) if is_reference_module(m) \
            else m
    out["modules"] = modules
    return out
