"""Tokenizers (counterpart of ``llms_on_kubernetes_tpu/engine/tokenizer.py``).

A copy of the JAX package's ``ByteTokenizer`` (ids 0-255 are UTF-8 bytes,
256 = BOS, 257 = EOS), so the port never imports the JAX package. The HF
and GGUF tokenizers wait for the checkpoint loader.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0-255 are bytes, 256=BOS, 257=EOS."""

    BOS = 256
    EOS = 257
    vocab_size = 258

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict],
                            tools: Optional[list] = None) -> list[int]:
        text = ""
        if tools:  # render schemas the way tool-aware templates do
            text += f"<tools>{json.dumps(tools, sort_keys=True)}</tools>"
        text += "".join(
            f"<{m.get('role', 'user')}>{m.get('content', '')}</{m.get('role', 'user')}>"
            for m in messages
        )
        return [self.BOS] + self.encode(text)

    @property
    def eos_ids(self) -> set[int]:
        return {self.EOS}


def load_tokenizer(model_ref: Optional[str] = None) -> ByteTokenizer:
    """The tokenizer for ``model_ref``: the byte tokenizer, until the HF
    and GGUF tokenizers are ported."""
    return ByteTokenizer()
