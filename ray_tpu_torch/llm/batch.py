"""Batch LLM inference — the port of ``ray_tpu/llm/batch.py``'s
``LLMBatchPredictor``: one engine per predictor, each batch of prompts
admitted together so the engine's continuous batching and ragged steps
amortize the batch.

    pred = LLMBatchPredictor({"preset": "llama3_8b"}, {"page_size": 16})
    rows = pred([{"prompt": "hello"}, ...])
    # rows gain "generated" (token ids), "generated_text", "finish_reason"

``batch_inference`` (a dataset through a pool of predictor actors) waits
for a copy of the data runtime.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.llm.engine import InferenceEngine
from ray_tpu_torch.llm.serve_llm import model_config_from_dict
from ray_tpu_torch.llm.tokenizer import ByteTokenizer


class LLMBatchPredictor:
    """Callable over a batch of rows (dicts holding ``prompt_column``, or
    bare prompts): text or token ids in, the rows with the generated
    tokens out. ``model_config`` as for ``LLMServer`` (preset "tiny" by
    default, which a CUDA device refuses at construction: its head dim
    8 is not one the kernels take); ``engine_config`` goes to
    InferenceEngine (``device`` defaults to "cuda")."""

    def __init__(self, model_config: Optional[Dict[str, Any]] = None,
                 engine_config: Optional[Dict[str, Any]] = None,
                 max_new_tokens: int = 32,
                 prompt_column: str = "prompt",
                 output_column: str = "generated",
                 detokenize: bool = True, tokenizer=None):
        cfg = model_config_from_dict(model_config)
        self.engine = InferenceEngine(cfg, **(engine_config or {}))
        self.max_new_tokens = max_new_tokens
        self.prompt_column = prompt_column
        self.output_column = output_column
        self.detokenize = detokenize
        self.tokenizer = tokenizer or ByteTokenizer()

    def __call__(self, batch: list) -> list:
        # admit the WHOLE batch up front: the engine packs prompts into
        # ragged steps and continuous-batches decode
        rid_to_idx: Dict[str, int] = {}
        for i, row in enumerate(batch):
            prompt = row[self.prompt_column] if isinstance(row, dict) \
                else row
            ids = self.tokenizer.encode(prompt) \
                if isinstance(prompt, str) else list(prompt)
            rid = self.engine.add_request(ids, self.max_new_tokens)
            rid_to_idx[rid] = i
        outputs: Dict[int, list] = {}
        while len(outputs) < len(batch):
            for rid, toks in self.engine.step().items():
                if rid in rid_to_idx:
                    outputs[rid_to_idx[rid]] = toks
        idx_to_rid = {i: rid for rid, i in rid_to_idx.items()}
        out_rows = []
        for i, row in enumerate(batch):
            toks = outputs[i]
            new = dict(row) if isinstance(row, dict) \
                else {self.prompt_column: row}
            new[self.output_column] = toks
            # WHY generation stopped — "stop" (EOS), "length" (budget) or
            # "evict" (cache pressure), which otherwise reads as a
            # silently short generation
            new["finish_reason"] = self.engine.finish_reason(idx_to_rid[i])
            if self.detokenize:
                new[f"{self.output_column}_text"] = \
                    self.tokenizer.decode(toks)
            out_rows.append(new)
        return out_rows
