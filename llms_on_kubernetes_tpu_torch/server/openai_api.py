"""OpenAI-compatible HTTP server on the standard library (counterpart of
``llms_on_kubernetes_tpu/server/openai_api.py``).

``http.server.ThreadingHTTPServer`` answers each connection on a thread of
its own; one ``EngineLoop`` thread drives ``Engine.step``. Handlers submit
requests and block on a per-HTTP-request queue that the engine thread
feeds through ``Request.on_event``. Server-sent events are written by hand
on an HTTP/1.0 response that ends when the connection closes.

Endpoints: ``GET /health``, ``GET /v1/models``, ``POST /v1/completions``,
``POST /v1/chat/completions`` (each with ``"stream": true``), and
``GET /debug/kernels`` / ``POST /debug/kernels/reset``, which read and
zero the kernel launch counters of ``kernels.LAUNCHES`` (the read also
gives the engine's prefill, chunk and decode call counts and the prompt
tokens served from the prefix cache, so launches can be held to calls). Response and chunk
shapes follow the JAX server's. Request options that change what is
generated and are not ported yet (``n`` > 1, ``best_of``, ``echo``,
``logprobs``, ``logit_bias``, ``stop`` strings, tools, ``response_format``)
are refused with 400 rather than ignored.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from llms_on_kubernetes_tpu_torch import kernels, resolve_device
from llms_on_kubernetes_tpu_torch.engine.engine import (
    Engine, EngineConfig, QueueFullError, SamplingParams, model_config_for,
)
from llms_on_kubernetes_tpu_torch.engine.tokenizer import load_tokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import resolve_model_dir

log = logging.getLogger(__name__)

_UNSUPPORTED = ("best_of", "echo", "logprobs", "top_logprobs", "logit_bias", "stop",
                "tools", "tool_choice", "response_format", "suffix")


class BadRequest(ValueError):
    pass


class IncrementalDetokenizer:
    """Text deltas from a growing token list, holding back a trailing
    incomplete UTF-8 sequence until its bytes arrive."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.ids: list[int] = []
        self.emitted = 0

    def push(self, ids: list[int], final: bool = False) -> str:
        self.ids += ids
        text = self.tokenizer.decode(self.ids)
        if not final:
            text = text.rstrip("\ufffd")
        delta = text[self.emitted:]
        self.emitted = max(self.emitted, len(text))
        return delta


class EngineLoop(threading.Thread):
    """Drives ``Engine.step`` while there is work; sleeps on an event
    otherwise. A failed step sheds every request with reason "error" so no
    client waits forever, and the loop carries on."""

    def __init__(self, engine: Engine):
        super().__init__(name="engine-loop", daemon=True)
        self.engine = engine
        self._wake = threading.Event()
        self._halt = threading.Event()

    def submit(self, prompt, params, on_event):
        req = self.engine.submit(prompt, params, on_event=on_event)
        self._wake.set()
        return req

    def run(self) -> None:
        while not self._halt.is_set():
            if not self.engine.has_work():
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            try:
                self.engine.step()
            except Exception:  # boundary: keep serving, fail the in-flight work
                log.error("engine step failed:\n%s", traceback.format_exc())
                self.engine.shed("error")

    def stop(self) -> None:
        self._halt.set()
        self._wake.set()


class OpenAIServer:
    """The HTTP front end of one engine serving one model."""

    def __init__(self, engine: Engine, tokenizer, model_name: str):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.loop = EngineLoop(engine)
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def bind(self, host: str = "0.0.0.0", port: int = 8080) -> ThreadingHTTPServer:
        server = self

        class Handler(_Handler):
            app = server

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        return self.httpd

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve on a background thread (tests); returns the bound port."""
        httpd = self.bind(host, port)
        self.loop.start()
        self._thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        self._thread.start()
        return httpd.server_address[1]

    def serve_forever(self, host: str, port: int) -> None:
        httpd = self.bind(host, port)
        self.loop.start()
        try:
            httpd.serve_forever()
        finally:
            self.close()

    def close(self) -> None:
        if self.httpd is not None:
            if self._thread is not None:
                self.httpd.shutdown()
                self._thread.join(timeout=10)
            self.httpd.server_close()
            self.httpd = None
        self.loop.stop()
        if self.loop.is_alive():
            self.loop.join(timeout=10)

    # -- request handling --------------------------------------------------

    def sampling_from_body(self, body: dict) -> SamplingParams:
        for key in _UNSUPPORTED:
            if body.get(key) not in (None, False, [], ""):
                raise BadRequest(f"{key!r} is not supported by this server yet")
        if body.get("n", 1) != 1:
            raise BadRequest("only n=1 is supported by this server yet")
        seed = body.get("seed")
        if seed is not None:
            if not isinstance(seed, int) or isinstance(seed, bool):
                raise BadRequest("seed must be an integer")
            seed &= 0x7FFFFFFF
        max_tokens = body.get("max_tokens") or body.get("max_completion_tokens") or 256
        try:
            return SamplingParams(
                temperature=float(body.get("temperature", 1.0)),
                top_p=float(body.get("top_p", 1.0)),
                top_k=int(body.get("top_k", 0)),
                max_tokens=int(max_tokens),
                stop_token_ids=tuple(sorted(self.tokenizer.eos_ids)),
                seed=seed,
                presence_penalty=float(body.get("presence_penalty", 0.0)),
                frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            )
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad sampling parameter: {e}")

    def prompt_from_body(self, body: dict, chat: bool) -> list[int]:
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise BadRequest("messages must be a non-empty list")
            if any(not isinstance(m, dict) or not isinstance(m.get("content", ""), str)
                   for m in messages):
                raise BadRequest("each message must be an object with string content")
            return self.tokenizer.apply_chat_template(messages)
        prompt = body.get("prompt", "")
        if isinstance(prompt, str):
            ids = self.tokenizer.encode(prompt)
        elif isinstance(prompt, list) and all(
                isinstance(t, int) and not isinstance(t, bool) for t in prompt):
            ids = list(prompt)
        elif isinstance(prompt, list) and len(prompt) == 1 and isinstance(prompt[0], str):
            ids = self.tokenizer.encode(prompt[0])
        else:
            raise BadRequest("prompt must be a string or a list of token ids "
                             "(one prompt per request)")
        if not ids:
            raise BadRequest("empty prompt")
        return ids


class _Handler(BaseHTTPRequestHandler):
    app: OpenAIServer
    server_version = "llms-on-kubernetes-tpu-torch"

    def log_message(self, fmt, *args):  # keep request logs off stderr
        log.debug("%s " + fmt, self.address_string(), *args)

    # -- plumbing ----------------------------------------------------------

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, obj) -> None:
        self._send(status, json.dumps(obj).encode(), "application/json")

    def _error(self, status: int, message: str, kind: str = "invalid_request_error") -> None:
        self._json(status, {"error": {"message": message, "type": kind}})

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n > 0 else b""
        try:
            body = json.loads(raw or b"{}")
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise BadRequest("invalid JSON")
        if not isinstance(body, dict):
            raise BadRequest("the request body must be a JSON object")
        return body

    # -- routes ------------------------------------------------------------

    def do_GET(self):
        if self.path == "/health":
            self._send(200, b"OK", "text/plain; charset=utf-8")
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [{
                "id": self.app.model_name, "object": "model",
                "created": int(time.time()),
                "owned_by": "llms-on-kubernetes-tpu-torch"}]})
        elif self.path == "/debug/kernels":
            eng = self.app.engine
            self._json(200, {"launches": kernels.launch_counts(),
                             "device": str(eng.device),
                             "num_layers": eng.model_config.num_layers,
                             "prefill_calls": eng.prefill_calls,
                             "chunk_calls": eng.chunk_calls,
                             "decode_forwards": eng.decode_forwards,
                             "prefix_hit_tokens": eng.allocator.hit_tokens_total})
        else:
            self._error(404, f"no route {self.path}", "not_found")

    def do_POST(self):
        if self.path == "/debug/kernels/reset":
            kernels.reset_launches()
            self._json(200, {"launches": kernels.launch_counts()})
            return
        if self.path not in ("/v1/completions", "/v1/chat/completions"):
            self._error(404, f"no route {self.path}", "not_found")
            return
        chat = self.path == "/v1/chat/completions"
        app = self.app
        try:
            body = self._read_json()
            params = app.sampling_from_body(body)
            prompt = app.prompt_from_body(body, chat)
            events: "queue.SimpleQueue" = queue.SimpleQueue()
            req = app.loop.submit(prompt, params, events.put)
        except BadRequest as e:
            self._error(400, str(e))
            return
        except QueueFullError as e:
            self._error(429, str(e), "rate_limit_exceeded")
            return
        except ValueError as e:          # engine validation (length, top_k, ...)
            self._error(400, str(e))
            return
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex
        created = int(time.time())
        try:
            if body.get("stream"):
                include_usage = bool((body.get("stream_options") or {}).get("include_usage"))
                self._stream(req, events, rid, created, chat, len(prompt), include_usage)
            else:
                self._full(req, events, rid, created, chat, len(prompt))
        except (BrokenPipeError, ConnectionResetError):
            app.engine.abort(req, "disconnect")

    def _drain(self, req, events):
        """Yield (text delta, finished, finish_reason) per engine event."""
        detok = IncrementalDetokenizer(self.app.tokenizer)
        while True:
            toks, done, reason = events.get()
            yield detok.push(toks, final=done), done, reason
            if done:
                return

    def _full(self, req, events, rid, created, chat, n_prompt) -> None:
        text, reason = "", None
        for delta, done, reason in self._drain(req, events):
            text += delta
        choice = {"index": 0, "finish_reason": reason}
        if chat:
            choice["message"] = {"role": "assistant", "content": text}
        else:
            choice["text"] = text
        n_out = len(req.output)
        self._json(200, {
            "id": rid, "object": "chat.completion" if chat else "text_completion",
            "created": created, "model": self.app.model_name, "choices": [choice],
            "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                      "total_tokens": n_prompt + n_out}})

    def _stream(self, req, events, rid, created, chat, n_prompt, include_usage) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        obj = "chat.completion.chunk" if chat else "text_completion"

        def write(payload) -> None:
            data = payload if isinstance(payload, str) else json.dumps(payload)
            self.wfile.write(f"data: {data}\n\n".encode())
            self.wfile.flush()

        def chunk(text: Optional[str], reason: Optional[str], role: bool = False) -> dict:
            if chat:
                delta: dict = {"role": "assistant"} if role else {}
                if text is not None:
                    delta["content"] = text
                choice = {"index": 0, "delta": delta, "finish_reason": reason}
            else:
                choice = {"index": 0, "text": text or "", "finish_reason": reason}
            return {"id": rid, "object": obj, "created": created,
                    "model": self.app.model_name, "choices": [choice]}

        if chat:
            write(chunk(None, None, role=True))
        signalled = False
        for delta, done, reason in self._drain(req, events):
            if delta or not signalled:
                # the first token always gets a chunk, even when its text is
                # held back or empty, so time-to-first-chunk tracks the
                # engine's first token
                write(chunk(delta, None))
                signalled = True
            if done:
                write(chunk(None, reason))
        if include_usage:
            n_out = len(req.output)
            write({"id": rid, "object": obj, "created": created,
                   "model": self.app.model_name, "choices": [],
                   "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                             "total_tokens": n_prompt + n_out}})
        write("[DONE]")
        self.close_connection = True


def serve(model: str = "debug-tiny", *, host: str = "0.0.0.0", port: int = 8080,
          device: str = "cuda", random_weights: bool = False,
          served_model_name: Optional[str] = None,
          engine_config: Optional[EngineConfig] = None,
          model_dir: Optional[str] = None) -> None:
    """Build the engine and serve until interrupted. ``model`` is a
    registry name, a checkpoint directory or a HF id found in the local
    cache; the weights come from ``model_dir`` (default: ``model``
    resolved by ``engine/weights.resolve_model_dir``, which raises
    FileNotFoundError on a miss), or are seeded random with
    ``random_weights``. ``device`` "cuda" (the default) raises without a
    GPU. The tokenizer is read first, then the CUDA kernels are built and
    the weights loaded onto the device, all before the server binds, so
    ``/health`` answers only once the model can serve."""
    dev = resolve_device(device)
    if not random_weights and model_dir is None:
        model_dir = resolve_model_dir(model)
    config_dir = model_dir or (model if os.path.isdir(model) else None)
    cfg = engine_config or EngineConfig(model=model)
    cfg.model, cfg.device = model, dev.type
    model_config = model_config_for(model, config_dir)
    tokenizer = load_tokenizer(config_dir or model)
    if dev.type == "cuda":
        kernels.build()
    t0 = time.perf_counter()
    engine = Engine(cfg, model_config=model_config,
                    model_dir=None if random_weights else model_dir)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    source = "seeded random weights" if random_weights else f"weights from {model_dir}"
    print(f"[serve] {model_config.name}: {source} on {dev.type} in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    OpenAIServer(engine, tokenizer, served_model_name or model).serve_forever(host, port)
