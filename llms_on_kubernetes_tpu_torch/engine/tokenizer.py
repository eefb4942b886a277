"""Tokenizers (counterpart of ``llms_on_kubernetes_tpu/engine/tokenizer.py``).

Copies of the JAX package's ``ByteTokenizer`` (ids 0-255 are UTF-8 bytes,
256 = BOS, 257 = EOS) and ``HFTokenizer`` (``transformers``' AutoTokenizer
over local files), and its ``load_tokenizer``, so the port never imports
the JAX package. ``transformers`` is imported only when a checkpoint
directory has tokenizer files; where it is not installed (the machine with
the card) that raises, naming the directory, and never falls back to the
byte tokenizer. The GGUF tokenizer is not ported yet.
"""

from __future__ import annotations

import json
import os
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


class HFTokenizer:
    """transformers AutoTokenizer over a checkpoint directory's own files
    (local files only)."""

    def __init__(self, path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise RuntimeError(
                f"{path} has tokenizer files, and reading them needs the transformers "
                f"package, which is not installed ({e})") from None
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict],
                            tools: Optional[list] = None) -> list[int]:
        return self._tok.apply_chat_template(
            messages, tools=tools, tokenize=True, add_generation_prompt=True
        )

    @property
    def eos_ids(self) -> set[int]:
        ids = set()
        if self._tok.eos_token_id is not None:
            ids.add(int(self._tok.eos_token_id))
        # llama-3 style end-of-turn
        for tok in ("<|eot_id|>", "<|im_end|>", "<end_of_turn>"):
            tid = self._tok.convert_tokens_to_ids(tok)
            if tid is not None and tid >= 0 and tid != getattr(self._tok, "unk_token_id", None):
                ids.add(int(tid))
        return ids


TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")


def load_tokenizer(model_ref: Optional[str] = None):
    """The tokenizer for ``model_ref``: ``HFTokenizer`` for a directory
    that has tokenizer files, else the byte tokenizer (a registry name, or
    a checkpoint directory with weights only)."""
    if model_ref and os.path.isdir(model_ref):
        if any(os.path.exists(os.path.join(model_ref, f)) for f in TOKENIZER_FILES):
            return HFTokenizer(model_ref)
    return ByteTokenizer()
