"""OpenAI tool/function-calling support for the chat endpoint
(counterpart of ``llms_on_kubernetes_tpu/server/tools.py``; a copy of that
framework-free module, so the port never imports the JAX package).

The reference's per-model servers were ``vllm/vllm-openai:v0.11.0``, which
serves ``tools`` / ``tool_choice``, including streamed ``tool_calls``
deltas and finish_reason "tool_calls". This module provides the
engine-side equivalents:

- ``validate_tools`` / ``validate_tool_choice``: request validation (400s
  at the API layer, never engine-thread exceptions).
- ``inject_tool_messages``: prompt-side plumbing for ``tool_choice``
  "required" / named-function forcing (the template renders the tool
  schemas themselves — HF chat templates take ``tools=``).
- ``ToolStreamParser``: incremental extraction of ``<tool_call>{json}
  </tool_call>`` blocks (the Hermes/Qwen convention — the reference's
  default model #2 is Qwen3-VL, whose template emits exactly this) from
  a streaming text delta sequence, with partial-tag holdback so a tag
  split across deltas is never half-emitted as content.

Parsing is text-stream-based by design: the engine samples freely and the
server recognizes the model's tool-call syntax, like vLLM's tool parsers.
A malformed/unterminated block degrades to plain content rather than a
500 (vLLM behavior).
"""

from __future__ import annotations

import json
import uuid
from typing import Optional

TOOL_CALL_START = "<tool_call>"
TOOL_CALL_END = "</tool_call>"


def validate_tools(tools) -> list[dict]:
    """OpenAI `tools` shape check -> the validated list. Raises ValueError
    with a client-addressable message on any shape problem."""
    if not isinstance(tools, list) or not tools:
        raise ValueError("tools must be a non-empty list")
    for t in tools:
        if not isinstance(t, dict) or t.get("type") != "function":
            raise ValueError("each tool must be {'type': 'function', ...}")
        fn = t.get("function")
        if not isinstance(fn, dict) or not isinstance(fn.get("name"), str) \
                or not fn["name"]:
            raise ValueError("each tool needs function.name (string)")
    return tools


def validate_tool_choice(tool_choice, tools: Optional[list]) -> Optional[str]:
    """Returns the normalized choice: None (no tool use), "auto",
    "required", or a function NAME to force. Raises ValueError on bad
    shapes or an unknown function name."""
    if tool_choice is None:
        return "auto" if tools else None
    if tool_choice == "none":
        return None
    if tool_choice in ("auto", "required"):
        if not tools:
            raise ValueError(f"tool_choice={tool_choice!r} requires tools")
        return tool_choice
    if isinstance(tool_choice, dict):
        name = (tool_choice.get("function") or {}).get("name")
        if tool_choice.get("type") != "function" or not isinstance(name, str):
            raise ValueError(
                "tool_choice object must be "
                "{'type': 'function', 'function': {'name': ...}}")
        known = {t["function"]["name"] for t in (tools or [])}
        if name not in known:
            raise ValueError(f"tool_choice names unknown function {name!r}")
        return name
    raise ValueError("tool_choice must be 'none', 'auto', 'required', or a "
                     "function object")


def inject_tool_messages(messages: list[dict], choice: Optional[str]) -> list[dict]:
    """Prompt-side nudge for "required" / named tool_choice: the chat
    template renders the tool schemas; this adds the instruction that a
    call MUST happen. The HARD guarantee is enforced separately by
    grammar-constrained decoding (engine/grammar.py — the sampled stream
    cannot be anything but well-formed tool calls); the instruction keeps
    the model emitting sensible content INSIDE the grammar.

    The instruction is appended to the LAST USER message's text — never
    as a trailing system message, which strict templates reject (Gemma
    raises on the system role; several Llama templates require
    system-first), turning a valid OpenAI request into a 400."""
    if choice in (None, "auto"):
        return messages
    if choice == "required":
        instr = ("You must respond with one or more tool calls "
                 "(<tool_call>...</tool_call>); do not answer in plain text.")
    else:
        instr = (f"You must respond with a call to the function "
                 f"{choice!r} (<tool_call>...</tool_call>); do not answer "
                 f"in plain text.")
    out = [dict(m) for m in messages]
    for m in reversed(out):
        if m.get("role") == "user":
            content = m.get("content", "")
            if isinstance(content, list):  # multimodal parts: add a text part
                m["content"] = list(content) + [{"type": "text",
                                                 "text": "\n\n" + instr}]
            else:
                m["content"] = f"{content}\n\n{instr}"
            return out
    return out + [{"role": "user", "content": instr}]


def _parse_block(raw: str) -> Optional[dict]:
    """``<tool_call>`` body -> OpenAI tool_call object, or None if the
    body is not the expected JSON shape."""
    try:
        obj = json.loads(raw.strip())
    except json.JSONDecodeError:
        return None
    if not isinstance(obj, dict) or not isinstance(obj.get("name"), str):
        return None
    args = obj.get("arguments", {})
    if isinstance(args, str):  # some models emit pre-serialized arguments
        args_str = args
    else:
        args_str = json.dumps(args)
    return {
        "id": "call_" + uuid.uuid4().hex[:24],
        "type": "function",
        "function": {"name": obj["name"], "arguments": args_str},
    }


class ToolStreamParser:
    """Incremental ``<tool_call>...</tool_call>`` extraction.

    ``push(delta, final)`` returns ``(content_delta, completed_calls)``:
    text outside blocks flows through as content (with at most
    ``len(TOOL_CALL_START) - 1`` characters of holdback against a tag
    split across deltas); each completed block yields one OpenAI
    tool_call object. On ``final`` with an unterminated or unparseable
    block, the raw text is returned as content (graceful degradation)."""

    def __init__(self):
        self._buf = ""          # unconsumed text (content mode)
        self._call_buf = ""     # inside-a-block accumulator
        self._in_call = False
        self.calls: list[dict] = []

    def push(self, delta: str, final: bool = False) -> tuple[str, list[dict]]:
        self._buf += delta
        out: list[str] = []
        new_calls: list[dict] = []
        while True:
            if self._in_call:
                # scan for the end tag over the ACCUMULATED body + new text
                # (the tag itself may be split across deltas); the start
                # offset avoids rescanning a long body every push
                combined = self._call_buf + self._buf
                scan_from = max(0, len(self._call_buf)
                                - len(TOOL_CALL_END) + 1)
                end = combined.find(TOOL_CALL_END, scan_from)
                if end == -1:
                    self._call_buf = combined
                    self._buf = ""
                    break
                self._call_buf = combined[:end]
                self._buf = combined[end + len(TOOL_CALL_END):]
                call = _parse_block(self._call_buf)
                if call is None:
                    # unparseable body: surface it verbatim as content
                    out.append(TOOL_CALL_START + self._call_buf
                               + TOOL_CALL_END)
                else:
                    new_calls.append(call)
                    self.calls.append(call)
                self._call_buf = ""
                self._in_call = False
                continue
            start = self._buf.find(TOOL_CALL_START)
            if start != -1:
                out.append(self._buf[:start])
                self._buf = self._buf[start + len(TOOL_CALL_START):]
                self._in_call = True
                continue
            # no full start tag: emit all but a possible partial-tag tail
            keep = 0
            if not final:
                n = len(self._buf)
                for k in range(min(len(TOOL_CALL_START) - 1, n), 0, -1):
                    if TOOL_CALL_START.startswith(self._buf[n - k:]):
                        keep = k
                        break
            out.append(self._buf[:len(self._buf) - keep])
            self._buf = self._buf[len(self._buf) - keep:]
            break
        if final:
            if self._in_call:  # unterminated block: degrade to content
                out.append(TOOL_CALL_START + self._call_buf)
                self._call_buf = ""
                self._in_call = False
            out.append(self._buf)
            self._buf = ""
        return "".join(out), new_calls
