"""LLM inference of the PyTorch port: paged KV cache, continuous batching
with its flight recorder, the server front end and the batch predictor
(``ray_tpu.llm`` counterparts)."""
