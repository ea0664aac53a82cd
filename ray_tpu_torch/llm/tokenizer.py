"""Byte-level tokenizer for string prompts (the port's copy of
``ray_tpu/llm/tokenizer.py``): UTF-8 bytes ARE the token ids. Real
checkpoints plug their own tokenizer in via ``LLMServer(tokenizer=...)``.
"""

from __future__ import annotations

from typing import List


class ByteTokenizer:
    vocab_size = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(max(0, min(255, int(i))) for i in ids).decode(
            "utf-8", errors="replace")
