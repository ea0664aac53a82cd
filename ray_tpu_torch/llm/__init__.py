"""LLM inference of the PyTorch port: paged KV cache, continuous batching
with its flight recorder, the server front end, the batch predictor and
``batch_inference`` over datasets (``ray_tpu.llm`` counterparts)."""
