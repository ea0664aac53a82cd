"""Batch LLM inference over datasets — the port of
``ray_tpu/llm/batch.py``: a dataset of prompts flows through a pool of
stateful predictor actors, one ``InferenceEngine`` per actor, each data
block's prompts admitted together so the engine's continuous batching and
ragged steps amortize the block.

    ds = ray_tpu_torch.data.from_items([{"prompt": "hello"}, ...])
    out = batch_inference(ds, model_config={"preset": "llama3_8b"},
                          engine_config={"page_size": 16})
    out.take_all()  # rows gain "generated" (token ids),
                    # "generated_text" and "finish_reason"

``LLMBatchPredictor`` is the class the pool's actors construct; called
on its own it runs one batch of rows. Scheduling, backpressure and block
accounting come from the data layer (``map_batches(cls,
compute=ActorPoolStrategy(n))``), which runs on the local-mode runtime
(``ray_tpu_torch.init(local_mode=True)``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.data.dataset import ActorPoolStrategy

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


def batch_inference(ds, *, model_config: Optional[Dict[str, Any]] = None,
                    engine_config: Optional[Dict[str, Any]] = None,
                    max_new_tokens: int = 32, concurrency: int = 1,
                    prompt_column: str = "prompt",
                    output_column: str = "generated",
                    detokenize: bool = True, tokenizer=None,
                    batch_size: Optional[int] = None):
    """Run every row's prompt through a pool of ``concurrency`` predictor
    actors; returns a dataset whose rows gain ``output_column`` (token
    ids), ``<output_column>_text`` and ``finish_reason`` (reference:
    ray.data.llm build_processor → processor(ds)). The configs go to
    ``LLMBatchPredictor``; each actor's engine runs on the card unless
    ``engine_config`` asks for the CPU. Pass ``tokenizer``
    (encode/decode) to replace the ByteTokenizer default."""
    return ds.map_batches(
        LLMBatchPredictor,
        compute=ActorPoolStrategy(concurrency),
        batch_format="rows", batch_size=batch_size,
        fn_constructor_kwargs={
            "model_config": model_config,
            "engine_config": engine_config,
            "max_new_tokens": max_new_tokens,
            "prompt_column": prompt_column,
            "output_column": output_column,
            "detokenize": detokenize,
            "tokenizer": tokenizer,
        })
