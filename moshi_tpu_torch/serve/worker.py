"""The multi-module production server (counterpart of
moshi_tpu/serve/worker.py): one TOML maps routes to modules, each warmed
up and its graphs captured before the first request.

    python -m moshi_tpu_torch.serve.worker --config X.toml [--host H] [--port P]
        [--ssl CERT_DIR] [--drain-timeout S] [--device cuda]

Behavioral reference: `rust/moshi-server/src/main.rs`: auth by the
`kyutai-api-key` header (or the `auth_id` query parameter) against
`authorized_ids`; `/metrics` (Prometheus text), `/api/build_info`,
`/api/modules_info`; `static_dir` for a web client.  A drain (POST
`/api/drain` with a key, or SIGTERM) answers 503 to new sessions and stops
the server once the open ones have finished or `--drain-timeout` passed.

Module types of the native schema (`[modules.NAME]`, `type`, `route`, and
`checkpoint_dir` or `hf_repo`, a hub repository, with `moshi_weights`,
`mimi_weights`, `tokenizer_file` and `revision` beside it;
serve/toml_compat.py reads the reference moshi-server schema, `type =
"BatchedAsr"` and its kin, with its `hf://` file paths, verbatim):
- `moshi`: one session at a time (serve/server.py), `kv_cache`, `cfg_coef`;
- `batched_moshi`: serve/batched_moshi.py, `batch_size`, `kv_cache`,
  `context`, `mimi_dtype`;
- `batched_asr` and `asr` (one slot): serve/batched_asr.py, `batch_size`,
  `asr_delay_in_tokens`, `temperature`, `conditioning_delay` or
  `conditioning_learnt_padding`, `kv_cache`, `context`, `weights`,
  `mimi_dtype`;
- `batched_tts`: serve/batched_tts.py, `batch_size`, `kv_cache`,
  `context`, `weights`, `mimi_dtype`, `temp`, `cfg_coef` (on a
  CFG-distilled model the voices' `cfg` condition, where the JAX
  package's module runs true CFG; on another it doubles the model batch),
  `n_q`,
  `max_padding`, `voice_dir`, `voices` (name -> file), `voice_frames`
  (by default the first voice file's);
- `tts`: serve/tts_ws.py, the same keys but the batch's.  The JAX package
  builds a streamer with its own compiled programs for every connection;
  here the module holds one captured streamer and its sessions take it in
  turn (the next one resets it in place; a connection waits while another
  session runs);
- `mimi`: serve/mimi_ws.py, the tokenizer socket on the route and the
  broadcast rooms on `route/{room}/send|recv`, or the reference's
  `send_path` / `recv_path` (a room by its `room_id` header), `rooms`,
  `default_room`;
- `py` / `py_post`: a user script whose `init(batch_size, config)` returns
  an app with `async handle(request)` (GET) or `async handle_post(request)`
  (POST), optionally `warmup()` and `async run_loop()` (moshi-server's
  py_module, py_module.rs:399-441);
- `py_batched_asr`: serve/py_basr.py, a user script's `init(batch_size,
  config)` app stepped with the bitmask protocol behind the msgpack ASR
  socket (`script`, `batch_size`, `asr_delay_in_tokens`,
  `text_tokenizer_file`, `config`).
A `moshi` module also takes `log_dir` (session token logs), and
`vault_url`, `fleet_auth` and `replicate_every` (cross-worker migration
through the dispatcher's vault, serve/dispatcher.py).
Not ported yet, and refused with NotImplementedError: the key `tp`.

Every model module loads onto `--device` (`cuda` by default, which must be
there).  After all modules have warmed up, `main` calls `gc.freeze()`: the
cycle collector keeps off what lives as long as the server.  aiohttp is
imported when an app is built, not with this module.
"""

import argparse
import asyncio
import gc
import importlib.util
import os
import signal
import subprocess
import time
import tomllib
from pathlib import Path

from .metrics import OPEN_CHANNELS, REGISTRY

# what the worker does not build yet -> the ROADMAP item it waits for
NOT_PORTED_TYPES: dict[str, str] = {}
NOT_PORTED_KEYS = {"tp": "A.13b (tensor-parallel serving)"}


def log(level: str, msg: str):
    print(f"[{level}] {msg}", flush=True)


def _refuse_not_ported(name: str, mcfg: dict):
    from .toml_compat import REFERENCE_TYPES
    mtype = REFERENCE_TYPES.get(mcfg["type"], mcfg["type"])
    if mtype in NOT_PORTED_TYPES:
        raise NotImplementedError(f"module {name}: type {mtype!r} is not ported yet "
                                  f"(ROADMAP {NOT_PORTED_TYPES[mtype]})")
    for key, item in NOT_PORTED_KEYS.items():
        if key in mcfg:
            raise NotImplementedError(f"module {name}: key {key!r} is not ported yet "
                                      f"(ROADMAP {item})")


def _build_py_module(name: str, mcfg: dict):
    """A user script's module: its `init(batch_size, config)` app, warmed
    up, its handler on the route and its `run_loop` started with the
    server."""
    mtype, route, script = mcfg["type"], mcfg["route"], Path(mcfg["script"])
    spec = importlib.util.spec_from_file_location(f"moshi_tpu_torch_py_module_{name}", script)
    if spec is None or spec.loader is None:
        raise ValueError(f"module {name}: cannot load script {script}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "init"):
        raise ValueError(f"module {name}: {script} defines no init()")
    app = mod.init(mcfg.get("batch_size", 1), dict(mcfg.get("config", {})))
    if hasattr(app, "warmup"):
        app.warmup()
    startup = None
    if hasattr(app, "run_loop"):
        async def startup():
            return asyncio.create_task(app.run_loop())
    handler_name = "handle_post" if mtype == "py_post" else "handle"
    if not hasattr(app, handler_name):
        raise ValueError(f"module {name}: init() result has no {handler_name}")
    return route, getattr(app, handler_name), startup, \
        {"type": mtype, "script": str(script), "batch_size": mcfg.get("batch_size", 1)}


# info keys of a module that /api/modules_info leaves out
_PRIVATE_INFO = ("state", "rooms", "load_s", "warmup_s")


def build_module(name: str, mcfg: dict, seed: int, device="cuda"):
    """One `[modules.NAME]` table -> (route, handler, startup coroutine
    factory or None, info dict); the module's engine is warmed up and its
    graphs captured (`info["state"]` holds it, for the app's lifetime;
    `load_s` and `warmup_s` are the seconds its loading and its warm-up
    with the captures took)."""
    from ..models.loaders import CheckpointInfo
    from .toml_compat import inline_checkpoint_info, is_reference_module, translate_module

    _refuse_not_ported(name, mcfg)
    if is_reference_module(mcfg):
        mcfg = translate_module(name, mcfg)
    mtype, route = mcfg["type"], mcfg["route"]
    if mtype in ("py", "py_post"):
        return _build_py_module(name, mcfg)
    if mtype == "py_batched_asr":
        from .py_basr import build_py_batched_asr
        return build_py_batched_asr(name, mcfg)
    if mtype not in ("moshi", "batched_moshi", "batched_asr", "asr", "tts", "batched_tts",
                     "mimi"):
        raise ValueError(f"unknown module type {mtype}")
    t0 = time.perf_counter()
    ckpt = mcfg.get("checkpoint_dir")
    if "_inline" in mcfg:
        info = inline_checkpoint_info(mcfg["_inline"])
    elif ckpt is not None:
        info = CheckpointInfo.from_dir(ckpt)
    elif "hf_repo" in mcfg:
        info = CheckpointInfo.from_hf_repo(
            mcfg["hf_repo"], moshi_weights=mcfg.get("moshi_weights"),
            mimi_weights=mcfg.get("mimi_weights"), tokenizer=mcfg.get("tokenizer_file"),
            revision=mcfg.get("revision"))
    else:
        raise ValueError(f"module {name}: set checkpoint_dir or hf_repo")
    if mtype == "mimi":
        return _build_mimi(mcfg, info, t0, device)
    if mtype in ("tts", "batched_tts"):
        return _build_tts(mcfg, info, t0, seed, device)
    tokenizer = info.get_text_tokenizer()

    if mtype == "moshi":
        from ..utils.serving import override_lm
        from .server import ServerState
        mimi, mimi_params = info.get_mimi(device=device)
        lm, lm_params = info.get_moshi(device=device)
        lm = override_lm(lm, mcfg.get("kv_cache"), mcfg.get("context"))
        gen_cfg = dict(info.lm_gen_config)
        ckpt_cfg_coef = gen_cfg.pop("cfg_coef", 1.0)
        state = ServerState(mimi, mimi_params, lm, lm_params, info=info,
                            text_tokenizer=tokenizer,
                            cfg_coef=mcfg.get("cfg_coef", ckpt_cfg_coef), device=device,
                            rng_seed=seed, log_dir=mcfg.get("log_dir"),
                            vault_url=mcfg.get("vault_url"), fleet_auth=mcfg.get("fleet_auth"),
                            replicate_every=mcfg.get("replicate_every", 125), **gen_cfg)
        return route, state.handle_chat, None, _warm(state, t0, {"type": mtype})

    if mtype == "batched_moshi":
        from .batched_moshi import build_state, handle_chat
        state = build_state(info, batch_size=mcfg.get("batch_size", 4), device=device,
                            kv_cache=mcfg.get("kv_cache"), context=mcfg.get("context"),
                            mimi_dtype=mcfg.get("mimi_dtype"), text_tokenizer=tokenizer,
                            rng_seed=seed)

        async def startup():
            return asyncio.create_task(state.run_loop())

        return route, (lambda req: handle_chat(req, state)), startup, \
            _warm(state, t0, {"type": mtype, "batch_size": state.batch_size})

    # "asr" is the reference's single-stream Asr module (asr.rs:16-33): the
    # same protocol, one slot
    from .batched_asr import build_state, handle_asr_socket
    state = build_state(
        info, batch_size=1 if mtype == "asr" else mcfg.get("batch_size", 8), device=device,
        asr_delay_in_tokens=mcfg.get("asr_delay_in_tokens"),
        temperature=mcfg.get("temperature", 0.0), kv_cache=mcfg.get("kv_cache"),
        context=mcfg.get("context"), weights=mcfg.get("weights"),
        mimi_dtype=mcfg.get("mimi_dtype"),
        conditioning_delay=mcfg.get("conditioning_delay"),
        conditioning_learnt_padding=mcfg.get("conditioning_learnt_padding", False),
        text_tokenizer=tokenizer, rng_seed=seed)

    async def startup():
        return asyncio.create_task(state.run_loop())

    return route, (lambda req: handle_asr_socket(req, state)), startup, \
        _warm(state, t0, {"type": mtype, "batch_size": state.batch_size})


def _build_tts(mcfg: dict, info, t0: float, seed: int, device):
    """The `tts` module (one captured streamer, its sessions in turn) or the
    `batched_tts` one."""
    from .batched_tts import build_state, handle_batched_tts_socket
    from .tts_ws import build_streamer, handle_tts_socket

    batched = mcfg["type"] == "batched_tts"
    batch_size = mcfg.get("batch_size", 8) if batched else 1
    knobs = dict(device=device, kv_cache=mcfg.get("kv_cache"), context=mcfg.get("context"),
                 weights=mcfg.get("weights"), mimi_dtype=mcfg.get("mimi_dtype"),
                 temp=mcfg.get("temp", 0.6), cfg_coef=mcfg.get("cfg_coef", 1.0),
                 n_q=mcfg.get("n_q", 32), max_padding=mcfg.get("max_padding"),
                 voice_dir=mcfg.get("voice_dir"), voice_aliases=mcfg.get("voices"),
                 voice_frames=mcfg.get("voice_frames"), rng_seed=seed)
    if not batched:
        streamer = build_streamer(info, **knobs)
        return mcfg["route"], (lambda req: handle_tts_socket(req, streamer)), None, \
            _warm(streamer, t0, {"type": "tts"})
    state = build_state(info, batch_size=batch_size, **knobs)

    async def startup():
        return asyncio.create_task(state.run_loop())

    return mcfg["route"], (lambda req: handle_batched_tts_socket(req, state)), startup, \
        _warm(state, t0, {"type": "batched_tts", "batch_size": batch_size})


def _build_mimi(mcfg: dict, info, t0: float, device):
    """The `mimi` module: the tokenizer socket on the route and the rooms on
    `route/{room}/send|recv`, or the reference's send and recv routes."""
    from .mimi_ws import (MimiRooms, MimiWsState, handle_mimi_socket, handle_room_recv,
                          handle_room_send)

    state = MimiWsState(*info.get_mimi(device=device))
    rooms = MimiRooms(state, allowed=mcfg.get("rooms"), default_room=mcfg.get("default_room"))
    route = mcfg["route"]
    info = {"type": "mimi", "state": state, "rooms": rooms, "load_s": time.perf_counter() - t0,
            "warmup_s": 0.0}
    if mcfg.get("recv_route"):
        info["_extra_routes"] = [(mcfg["recv_route"], lambda req: handle_room_recv(req, rooms))]
        return route, (lambda req: handle_room_send(req, rooms)), None, info
    info["_extra_routes"] = [(route + "/{room}/send", lambda req: handle_room_send(req, rooms)),
                             (route + "/{room}/recv", lambda req: handle_room_recv(req, rooms))]
    return route, (lambda req: handle_mimi_socket(req, state)), None, info


def _warm(state, t0: float, info: dict) -> dict:
    """Warm the engine up and capture its graphs; `info` with the engine
    and the seconds of loading (since t0) and of the warm-up."""
    loaded = time.perf_counter()
    state.warmup()
    state.capture()
    return {**info, "state": state, "load_s": loaded - t0,
            "warmup_s": time.perf_counter() - loaded}


def make_ssl_context(cert_dir: str | Path):
    """TLS in the process: cert.pem / key.pem from `cert_dir`, a
    self-signed pair made there with openssl on first use."""
    import ssl
    cert_dir = Path(cert_dir)
    cert_dir.mkdir(parents=True, exist_ok=True)
    cert, key = cert_dir / "cert.pem", cert_dir / "key.pem"
    if not cert.exists() or not key.exists():
        subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                        "-keyout", str(key), "-out", str(cert), "-days", "365",
                        "-subj", "/CN=localhost"], check=True, capture_output=True)
        log("info", f"generated a self-signed TLS certificate in {cert_dir}")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(str(cert), str(key))
    return ctx


def build_app(cfg: dict, drain_timeout: float = 360.0, device="cuda"):
    """The worker's aiohttp app from a parsed TOML: module routes, the auth
    and drain middlewares, /metrics, /api/*, the static directory.  The
    modules' engines are in `app["modules"]` (name -> info with "state")
    and live as long as the app; `app["start_drain"]()` starts a drain."""
    from aiohttp import web

    authorized = set(cfg.get("authorized_ids", []))
    draining = {"on": False}
    module_routes: list[str] = []

    @web.middleware
    async def auth_middleware(request, handler):
        if authorized and not request.path.startswith(("/metrics", "/api/build_info")):
            key = request.headers.get("kyutai-api-key") or request.query.get("auth_id")
            if key not in authorized:
                return web.Response(status=401, text="unauthorized")
        return await handler(request)

    @web.middleware
    async def drain_middleware(request, handler):
        # during a drain module routes refuse new sessions; the
        # observability endpoints stay open
        if draining["on"] and any(request.path.startswith(r) for r in module_routes):
            return web.Response(status=503, text="draining")
        return await handler(request)

    app = web.Application(middlewares=([auth_middleware] if authorized else [])
                          + [drain_middleware])
    drain_gauge = REGISTRY.gauge("draining", "1 while the worker refuses new sessions")

    def start_drain():
        if draining["on"]:
            return
        draining["on"] = True
        drain_gauge.inc()
        log("info", f"draining: no new sessions; exiting when idle "
                    f"(open={OPEN_CHANNELS.value:g}, timeout={drain_timeout}s)")

        async def watcher():
            t0 = time.time()
            while OPEN_CHANNELS.value > 0 and time.time() - t0 < drain_timeout:
                await asyncio.sleep(1.0)
            log("info", "drained; shutting down")
            signal.raise_signal(signal.SIGINT)  # run_app cleans up

        asyncio.ensure_future(watcher())

    app["start_drain"] = start_drain
    app["draining"] = draining

    async def drain_handler(_):
        start_drain()
        return web.json_response({"draining": True, "open": OPEN_CHANNELS.value})

    app.router.add_post("/api/drain", drain_handler)
    modules, modules_info, startups = {}, {}, []
    for i, (name, mcfg) in enumerate(cfg.get("modules", {}).items()):
        t0 = time.perf_counter()
        route, handler, startup, minfo = build_module(name, mcfg, seed=i, device=device)
        if minfo["type"] == "py_post":
            app.router.add_post(route, handler)
        else:
            app.router.add_get(route, handler)
        for extra_route, extra_handler in minfo.pop("_extra_routes", []):
            app.router.add_get(extra_route, extra_handler)
        modules[name] = minfo
        modules_info[name] = {k: v for k, v in minfo.items() if k not in _PRIVATE_INFO}
        modules_info[name]["route"] = route
        module_routes.append(route)
        if startup is not None:
            startups.append(startup)
        log("info", f"mounted {name} ({minfo['type']}) at {route} in "
                    f"{time.perf_counter() - t0:.1f} s")
    app["modules"] = modules

    async def metrics_handler(_):
        return web.Response(text=REGISTRY.expose(), content_type="text/plain")

    async def build_info(_):
        try:
            rev = subprocess.check_output(["git", "rev-parse", "HEAD"], text=True,
                                          stderr=subprocess.DEVNULL).strip()
        except Exception:
            rev = "unknown"
        return web.json_response({"build_git_revision": rev, "framework": "moshi_tpu_torch"})

    async def modules_handler(_):
        return web.json_response(modules_info)

    app.router.add_get("/metrics", metrics_handler)
    app.router.add_get("/api/build_info", build_info)
    app.router.add_get("/api/modules_info", modules_handler)

    static_dir = cfg.get("static_dir")
    if static_dir and not Path(static_dir).is_dir():
        log("warn", f"static_dir {static_dir!r} does not exist; serving without a web UI")
        static_dir = None
    if static_dir:
        async def handle_root(_):
            return web.FileResponse(os.path.join(static_dir, "index.html"))

        app.router.add_get("/", handle_root)
        app.router.add_static("/", path=static_dir, follow_symlinks=True, name="static")

    async def on_startup(app_):
        app_["tasks"] = [await s() for s in startups]

    app.on_startup.append(on_startup)
    return app


def main(argv=None):
    from aiohttp import web

    from ..utils.serving import serving_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=8998)
    ap.add_argument("--ssl", metavar="CERT_DIR", default=None,
                    help="serve https/wss; makes a self-signed certificate in CERT_DIR "
                         "if none is there")
    ap.add_argument("--drain-timeout", type=float, default=360.0,
                    help="the longest wait for open sessions after a drain (SIGTERM or "
                         "POST /api/drain)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = serving_device(args.device)
    cfg = tomllib.loads(Path(args.config).read_text())
    app = build_app(cfg, drain_timeout=args.drain_timeout, device=device)
    # what the warm-ups made lives as long as the server: keep the cycle
    # collector off it (a full pass costs 100s of ms in a frame)
    gc.freeze()

    async def install_sigterm(app_):
        try:
            # SIGTERM (docker stop, a rolling deploy) drains instead of
            # ending open sessions
            asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, app_["start_drain"])
        except (NotImplementedError, RuntimeError):
            pass

    app.on_startup.append(install_sigterm)
    ssl_context = make_ssl_context(args.ssl) if args.ssl else None
    web.run_app(app, host=args.host, port=args.port, ssl_context=ssl_context)


if __name__ == "__main__":
    main()
