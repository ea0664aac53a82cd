"""LLMServer — the request front end over InferenceEngine, the PyTorch
port of ``ray_tpu/llm/serve_llm.py``.

Requests arriving on any caller thread enqueue into the engine and block
on a per-request event; a single engine thread runs the
continuous-batching loop, so concurrent requests share ragged steps.
``stream()`` is a generator yielding token batches as they are decoded.
OpenAI-style ``completions``/``chat_completions`` bodies, streaming or
not, ride the same two paths.

Each request's engine record carries the caller's ambient trace id
(``util/trace_context``), and the log records the server emits for it
carry its request id and that trace id (``util/log_plane``; the server
installs the process logger). ``request_records()`` is the engine's
flight-recorder snapshot; ``set_overload_level()`` is the degradation
ladder's hook on the step token budget.

``build_llm_app`` binds the server as a ``ray_tpu_torch.serve``
deployment whose replica books ``{"GPU": tp·pp}`` when its engine runs on
the card (``placement_for_engine``), so the replica runs in a worker of
its own that sees only its card. At ``tp > 1`` that worker's one
engine process drives the ``tp`` cards of its lease (``llm/tp.py``).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from ray_tpu_torch.config import llm_defaults
from ray_tpu_torch.llm.engine import InferenceEngine
from ray_tpu_torch.llm.tokenizer import ByteTokenizer
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.util import log_plane, trace_context


def _ambient_trace_id() -> str:
    """The trace_id ambient on the caller's context, linked into the
    engine's flight-recorder record so a request's record, its log lines
    and its trace share one id."""
    amb = trace_context.current()
    return amb[0] if amb else ""


def model_config_from_dict(model_config: Optional[Dict[str, Any]]
                           ) -> LlamaConfig:
    """A config dict -> LlamaConfig: ``preset`` names a LlamaConfig preset
    ("tiny", the default, as in the JAX server, or "llama3_8b"); the
    other keys override its fields, dtypes given as torch dtypes or
    their names ("bfloat16")."""
    kw = dict(model_config or {})
    preset = kw.pop("preset", "tiny")
    if preset not in ("tiny", "llama3_8b"):
        raise ValueError(f"unknown preset {preset!r}")
    for name in ("dtype", "param_dtype"):
        if isinstance(kw.get(name), str):
            kw[name] = getattr(torch, kw[name])
    return getattr(LlamaConfig, preset)(**kw)


class LLMServer:
    """Accepts {"prompt_ids": [...] | "prompt": str, "max_tokens": N} and
    returns {"token_ids": [...], "request_id": rid}. ``engine_config``
    goes to InferenceEngine (``device`` defaults to "cuda")."""

    def __init__(self, model_config: Optional[Dict[str, Any]] = None,
                 engine_config: Optional[Dict[str, Any]] = None,
                 tokenizer=None, model_name: str = "rtpu-llm",
                 chat_template=None):
        cfg = model_config_from_dict(model_config)
        self.engine = InferenceEngine(cfg, **(engine_config or {}))
        self.engine.track_progress = True  # the serve loop drains it
        # the process logger its request records go to: a cluster worker
        # has one already (worker_main installs it); elsewhere the server
        # installs it
        log_plane.ensure_started(role="llm")
        self.tokenizer = tokenizer or ByteTokenizer()
        self.model_name = model_name
        self.chat_template = chat_template or apply_chat_template
        self._results: Dict[str, List[int]] = {}
        self._events: Dict[str, threading.Event] = {}
        self._abandoned: set = set()
        # rid -> queue of incremental token lists (None = stream end)
        self._token_qs: Dict[str, "queue_mod.Queue"] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the engine thread (after its current step)."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self.engine.has_work():
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            finished = self.engine.step()
            progress = self.engine.drain_progress()
            with self._lock:
                for rid, new_toks in progress.items():
                    q = self._token_qs.get(rid)
                    if q is not None and new_toks:
                        q.put(list(new_toks))
                for rid, toks in finished.items():
                    q = self._token_qs.get(rid)
                    if q is not None:
                        q.put(None)  # end of stream
                        continue
                    if rid in self._abandoned:
                        self._abandoned.discard(rid)
                        continue
                    self._results[rid] = toks
                    ev = self._events.get(rid)
                    if ev is not None:
                        ev.set()

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        prompt = self._prompt_ids(request)
        max_tokens = int(request.get("max_tokens", 32))
        ev = threading.Event()
        rid = self.engine.add_request(prompt, max_tokens,
                                      trace_id=_ambient_trace_id())
        # ambient request id: every log record emitted while this
        # request is in flight on this thread carries request_id=rid
        with log_plane.request_context(rid):
            log_plane.get_logger().info(
                f"llm request start ({len(prompt)} prompt tok, "
                f"max_new {max_tokens})")
            with self._lock:
                self._events[rid] = ev
                if rid in self._results:  # engine already finished it
                    ev.set()
            self._wake.set()
            if not ev.wait(timeout=300):
                # the engine still finishes the request; mark it
                # abandoned so the loop drops the late result instead of
                # leaking it
                with self._lock:
                    self._events.pop(rid, None)
                    self._abandoned.add(rid)
                log_plane.get_logger().warning("llm request timed out")
                raise TimeoutError(f"LLM request {rid} timed out")
            with self._lock:
                toks = self._results.pop(rid)
                self._events.pop(rid, None)
            log_plane.get_logger().info(
                f"llm request finished ({len(toks)} tok)")
        return {"token_ids": toks, "request_id": rid}

    # ------------------------------------------------------------ streaming

    def stream(self, request: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        """Generator: yields {"token_ids": [...]} batches as the engine
        produces them, then {"done": True, "token_ids": <all>}."""
        prompt = self._prompt_ids(request)
        max_tokens = int(request.get("max_tokens", 32))
        q: "queue_mod.Queue" = queue_mod.Queue()
        with self._lock:
            rid = self.engine.add_request(prompt, max_tokens,
                                          trace_id=_ambient_trace_id())
            self._token_qs[rid] = q
        # a generator can't hold the ambient contextvar across yields
        # without leaking it into the consumer, so stamp the lifecycle
        # records explicitly instead
        with log_plane.request_context(rid):
            log_plane.get_logger().info(
                f"llm stream start ({len(prompt)} prompt tok, "
                f"max_new {max_tokens})")
        self._wake.set()
        produced: List[int] = []
        completed = False
        try:
            while True:
                item = q.get(timeout=300)
                if item is None:
                    completed = True
                    break
                produced.extend(item)
                yield {"token_ids": item, "request_id": rid}
            with log_plane.request_context(rid):
                log_plane.get_logger().info(
                    f"llm stream finished ({len(produced)} tok)")
            yield {"done": True, "request_id": rid,
                   "token_ids": list(produced),
                   "finish_reason": self.engine.finish_reason(rid),
                   "cached_tokens": self.engine.cached_tokens(rid)}
        finally:
            with self._lock:
                self._token_qs.pop(rid, None)
                if not completed:
                    # consumer went away mid-stream: drop the late result
                    self._results.pop(rid, None)
                    self._abandoned.add(rid)

    def _prompt_ids(self, request: Dict[str, Any]) -> List[int]:
        if "prompt_ids" in request:
            return list(request["prompt_ids"])
        prompt = request.get("prompt")
        if isinstance(prompt, str):
            return self.tokenizer.encode(prompt)
        if isinstance(prompt, list):
            return list(prompt)
        raise ValueError("request needs 'prompt' (str) or 'prompt_ids'")

    # --------------------------------------------------------- OpenAI API

    def _completion_body(self, rid: str, token_ids: List[int],
                         n_prompt: int, finish_reason: Optional[str],
                         cached: int = 0) -> Dict[str, Any]:
        return {
            "id": f"cmpl-{rid}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{"index": 0,
                         "text": self.tokenizer.decode(token_ids),
                         "token_ids": list(token_ids),
                         "logprobs": None,
                         "finish_reason": finish_reason}],
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": len(token_ids),
                      "total_tokens": n_prompt + len(token_ids),
                      "prompt_tokens_details": {"cached_tokens": cached}},
        }

    def completions(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """OpenAI-style /v1/completions, non-streaming."""
        prompt = self._prompt_ids(request)
        out = self.__call__({"prompt_ids": prompt,
                             "max_tokens": request.get("max_tokens", 32)})
        return self._completion_body(
            out["request_id"], out["token_ids"], len(prompt),
            self.engine.finish_reason(out["request_id"]),
            self.engine.cached_tokens(out["request_id"]))

    def completions_stream(self, request: Dict[str, Any]
                           ) -> Iterator[Dict[str, Any]]:
        """OpenAI-style streaming chunks; each carries the new text delta,
        the terminal chunk the finish reason and usage."""
        prompt = self._prompt_ids(request)
        for item in self.stream({"prompt_ids": prompt,
                                 "max_tokens":
                                     request.get("max_tokens", 32)}):
            rid = item["request_id"]
            if item.get("done"):
                chunk = self._completion_body(
                    rid, [], len(prompt),
                    item.get("finish_reason", "length"),
                    item.get("cached_tokens", 0))
                chunk["object"] = "text_completion.chunk"
                n_out = len(item.get("token_ids", ()))
                chunk["usage"]["completion_tokens"] = n_out
                chunk["usage"]["total_tokens"] = len(prompt) + n_out
                yield chunk
                return
            chunk = self._completion_body(rid, item["token_ids"],
                                          len(prompt), None)
            chunk["object"] = "text_completion.chunk"
            chunk.pop("usage")
            yield chunk

    # ----------------------------------------------------- chat completions

    def _chat_prompt_ids(self, request: Dict[str, Any]) -> List[int]:
        messages = request.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError("chat request needs a non-empty 'messages' "
                             "list")
        return self.tokenizer.encode(self.chat_template(messages))

    def _chat_body(self, rid: str, content: str, n_prompt: int,
                   n_out: int, finish_reason,
                   cached: int = 0) -> Dict[str, Any]:
        return {
            "id": f"chatcmpl-{rid}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{"index": 0,
                         "message": {"role": "assistant",
                                     "content": content},
                         "finish_reason": finish_reason}],
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": n_out,
                      "total_tokens": n_prompt + n_out,
                      "prompt_tokens_details": {"cached_tokens": cached}},
        }

    def chat_completions(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """OpenAI-style /v1/chat/completions, non-streaming."""
        prompt = self._chat_prompt_ids(request)
        out = self.__call__({"prompt_ids": prompt,
                             "max_tokens": request.get("max_tokens", 32)})
        toks = out["token_ids"]
        return self._chat_body(
            out["request_id"], self.tokenizer.decode(toks), len(prompt),
            len(toks), self.engine.finish_reason(out["request_id"]),
            self.engine.cached_tokens(out["request_id"]))

    def chat_completions_stream(self, request: Dict[str, Any]
                                ) -> Iterator[Dict[str, Any]]:
        """OpenAI chat streaming chunks: the first delta carries the role,
        then content deltas, then the terminal chunk with finish_reason
        and usage."""
        prompt = self._chat_prompt_ids(request)
        first = True
        for item in self.stream({"prompt_ids": prompt,
                                 "max_tokens":
                                     request.get("max_tokens", 32)}):
            rid = item["request_id"]
            if item.get("done"):
                chunk = self._chat_body(
                    rid, "", len(prompt), len(item.get("token_ids", ())),
                    item.get("finish_reason", "length"),
                    item.get("cached_tokens", 0))
                chunk["object"] = "chat.completion.chunk"
                chunk["choices"][0]["delta"] = {}
                del chunk["choices"][0]["message"]
                yield chunk
                return
            delta: Dict[str, Any] = {
                "content": self.tokenizer.decode(item["token_ids"])}
            if first:
                delta = {"role": "assistant", **delta}
                first = False
            chunk = self._chat_body(rid, "", len(prompt), 0, None)
            chunk["object"] = "chat.completion.chunk"
            chunk["choices"][0]["delta"] = delta
            del chunk["choices"][0]["message"]
            chunk.pop("usage")
            yield chunk

    def stats(self) -> Dict[str, Any]:
        out = dict(self.engine.stats)
        prefix = self.engine.prefix
        if prefix is not None:
            out["prefix_cache"] = {
                "lookups": prefix.lookups, "hits": prefix.hits,
                "hit_tokens": prefix.hit_tokens,
                "evictions": prefix.evictions,
                "cached_pages": prefix.num_cached,
                "evictable_pages": prefix.num_evictable,
            }
        return out

    def request_records(self) -> List[Dict[str, Any]]:
        """Flight-recorder snapshot of this server's engine (wire dicts;
        [] when the recorder is disabled)."""
        if self.engine.request_log is None:
            return []
        return self.engine.request_log.snapshot()

    def set_overload_level(self, level: int,
                           budget_factor: float = 0.5) -> int:
        """Degradation ladder hook: level n runs the engine at
        step_token_budget * budget_factor**n — tighter prefill admission
        keeps decode TPOT alive for already-admitted requests at the cost
        of new-request TTFT. Level 0 restores the configured budget.
        Returns the effective budget (an unbounded base budget of 0
        degrades from the config default so level>0 always tightens
        something)."""
        if not hasattr(self, "_base_token_budget"):
            self._base_token_budget = self.engine.step_token_budget
        level = max(0, int(level))
        if level == 0:
            self.engine.step_token_budget = self._base_token_budget
        else:
            base = self._base_token_budget or \
                llm_defaults()["llm_step_token_budget"] or 2048
            self.engine.step_token_budget = max(
                64, int(base * (budget_factor ** level)))
        return self.engine.step_token_budget

    def check_health(self) -> None:
        if not self._thread.is_alive():
            raise RuntimeError("engine thread died")


def apply_chat_template(messages: List[Dict[str, Any]]) -> str:
    """Default role templating: an explicit llama-chat-style marker form
    for the byte-level tokenizer (swap via LLMServer(chat_template=...))."""
    parts = []
    for m in messages:
        role = str(m.get("role", "user"))
        content = str(m.get("content", ""))
        parts.append(f"<|{role}|>\n{content}")
    parts.append("<|assistant|>\n")
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# Placement derivation: parallel degrees -> gang bundles
# ---------------------------------------------------------------------------

def placement_for_engine(tp: int = 1, pp: int = 1,
                         gpus_per_host: int = 8):
    """(bundles, strategy) derived from the engine's parallel degrees —
    the reference computes the same from TP×PP engine_kwargs (reference:
    llm/_internal/serve/deployments/llm/vllm/vllm_models.py:128-153).

    A tp-group must sit on one host's NVLink, so a group that fits one
    host is ONE bundle of tp·pp cards (STRICT_PACK); a group spanning
    hosts becomes one whole-host bundle per host, PACKed.
    """
    world = max(1, int(tp)) * max(1, int(pp))
    if world <= gpus_per_host:
        return [{"GPU": float(world)}], "STRICT_PACK"
    if world % gpus_per_host:
        raise ValueError(
            f"tp*pp={world} spans hosts but is not a multiple of "
            f"gpus_per_host={gpus_per_host}")
    n_hosts = world // gpus_per_host
    return ([{"GPU": float(gpus_per_host)}] * n_hosts), "PACK"


def build_llm_app(model_config: Optional[Dict[str, Any]] = None,
                  engine_config: Optional[Dict[str, Any]] = None, *,
                  name: str = "llm", num_replicas: int = 1,
                  max_ongoing_requests: int = 16,
                  runtime_env: Optional[Dict[str, Any]] = None,
                  use_gpu_resources: Optional[bool] = None,
                  model_name: str = "rtpu-llm"):
    """Bind an LLMServer deployment whose replica resources are DERIVED
    from the engine's parallel degrees (reference: the LLM deployment's
    placement-group shorthand, vllm_models.py:128-153).

    With ``use_gpu_resources=None`` a replica books ``{"GPU": tp·pp}``
    whenever its engine runs on the card (``engine_config["device"]``,
    "cuda" by default, as for ``LLMServer``), so it gets a worker of its
    own under ``CUDA_VISIBLE_DEVICES``. This differs from the JAX
    package's ``build_llm_app``, which books chips only for a tp > 1
    gang: a pooled CPU worker inherits the node's environment and sees
    every card, so two unbooked replicas would share card 0 with nothing
    reserved, and a tp=1 engine on the card needs its one card as much
    as a gang needs its cards. ``use_gpu_resources=False`` skips the
    reservation.

    At ``tp > 1`` the booking is one STRICT_PACK bundle of ``tp`` cards,
    and the replica's one engine process drives the cards its lease
    makes visible (the first ``tp``, ``llm/tp.py``). A tp group larger
    than one host's cards needs one engine process per host and raises
    NotImplementedError, as in the JAX package.
    """
    from ray_tpu_torch import serve as serve_mod
    engine_config = dict(engine_config or {})
    tp = int(engine_config.get("tp", 1))
    ray_actor_options: Dict[str, Any] = {}
    if use_gpu_resources is None:
        use_gpu_resources = engine_config.get("device", "cuda") == "cuda"
    if use_gpu_resources:
        bundles, _ = placement_for_engine(tp)
        if len(bundles) > 1:
            raise NotImplementedError(
                "tp groups spanning hosts need one engine process per "
                "host; shard within one host's cards or raise "
                "gpus_per_host")
        ray_actor_options["resources"] = bundles[0]
    if runtime_env:
        ray_actor_options["runtime_env"] = runtime_env
    dep = serve_mod.deployment(
        name=name, num_replicas=num_replicas,
        max_ongoing_requests=max_ongoing_requests,
        ray_actor_options=ray_actor_options or None)(LLMServer)
    return dep.bind(model_config, engine_config, None, model_name)
