#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing loudly (an uncaught error exits non-zero before the
result line is printed):
  1. require CUDA; print the card's name and power limit;
  2. build every CUDA kernel from the sources in this checkout (one nvcc
     per source, all started together), print the build time and what
     ``-Xptxas -v`` says of the bf16 kernels redesigned for Hopper (the
     flash forward, dq and dk/dv, each tile variant on its own line, the
     ragged kernel, the decode op's ring walk and its merge: registers,
     barriers, stack and spill bytes), and each flash tile variant's
     shared memory, the libraries' count held equal to the tuner's model;
  3. hold each kernel against its plain PyTorch version at the main
     path's shapes (Llama-3-8B attention: Hq 32, Hkv 8, D 128, page 16),
     bf16 and int8 pools, and time kernel, plain version and the PyTorch
     library call that computes the same function (a yardstick only);
 3b. the decode op ``paged_attention`` at the same widths: a decode batch
     of 8 up to 2048 tokens (bf16 and fp32 pools), one of 8 x 8192 (bf16)
     and batch C at bench_llm.py's widths, split as ``decode_plan`` says,
     the kernel against both plain versions (the split one at the plan's
     split size), a planted fault that must fail on every row, a length-0
     row that must come back 0, two calls equal bit for bit, times beside
     the bound and SDPA, and the kernel at other split sizes;
  4. the main path: ``LLMServer`` at Llama-3-8B widths, all 32 layers,
     bf16, random weights from a seed, answering concurrent requests
     through ``__call__`` and ``stream`` (one prompt prefilled in chunks,
     one prefix-cache hit; the first wave admitted at one engine step,
     so that phase 14's worker schedules it alike); every launch counter is set to 0 just before
     and read just after, and must match the engine's step counts. The
     flight recorder is on (the default): each request's TTFT, TPOT and
     end-to-end time from its record beside the external timer, held to
     bench_llm.py's rule (|record - timer| <= max(5 ms, 15%)), and the
     TTFT and end-to-end times also trailing the timer by 0 to 10 ms,
     where the same times stamped at each dispatch's launch must trail it
     by more (what a launch-time stamp would read); the engine
     gauges after a forced update; the step programs dispatched (the
     first engine of the process: at most 3); one request sent under an
     ambient trace, whose log records must carry its request id and that
     trace id, as its record does;
 3c. (run after phase 4, whose program count it would join) the decode op
     on the engine's own decode steps (Llama-3-8B widths, 2 layers, the
     main path's engine): on every decode-loop step it runs beside the
     ragged kernel on the same live pools and must agree with it; its
     launches, counted from 0, must be layers x decode steps;
  5. the engine against the model's full forward pass on the card: 8B
     widths, 2 layers, fp32, greedy tokens compared where the oracle's
     top-2 margin exceeds fp32 summation noise;
 5b. the JAX package's serving widths (bench_llm.py: dim 1024, 16 / 8
     heads, head dim 64, pages of 32): phase 3 on its batches, a server
     (2 layers, bf16) answering phase 4's requests with its launches
     counted and phase 4's recorder checks, and phase 5's oracle (fp32);
     phase 3b's batch C is the decode op at these widths; then
     bench_llm.py's recorder A/B (8 requests x 64 tokens of decode wall
     time, recorder off and on, printed), and ``LLMBatchPredictor`` over
     8 rows (fp32), whose tokens and finish reasons must equal the
     engine's ``generate`` on the same prompts;
  6. hold the three flash-attention kernels (forward, dq, dk/dv), every
     tile variant each is built for, against their plain versions at the
     training path's shape (B 8, H 24, L 2048, D 128, bf16; causal,
     non-causal, and causal with an lse cotangent), catch two planted
     faults on every 64-row query tile, check that each variant repeats
     bit for bit, and time kernels (every variant), plain versions and the
     PyTorch library call, each kernel with its achieved TFLOP/s and its
     share of the bound, and dq + dk/dv against the library's whole
     backward; then the same checks, every variant, at lengths no kernel
     tile divides (L 72, 200 and 1000, and Lq 72 against Lk 200), the
     planted causal fault included;
  7. the training main path: ``make_train_step`` over ``loss_fn`` at the
     JAX package's bench widths (vocab 32000, dim 3072, 8 layers, 24/12
     heads, ffn 12288: 1,230,818,304 parameters; flash attention, selective
     remat), fp32 master weights from seed 0, bf16 compute, ``Adafactor``
     (bench.py's optax.adafactor(1e-3)), B 8 x L 2048 tokens from seed 1:
     2 warm-up and 5 timed steps on one batch, the flash launch counters
     set to 0 just before and read just after; then the step profiler's
     phases and the gauges it sets, and the device's busy share of one
     step; then AdamW (optax.adamw's defaults, the earlier optimizer), 2
     warm-up and 3 timed steps on the same configuration, for comparison;
 7b. the sweep bench.py runs before its steps: ``autotune_blocks`` at
     phase 7's attention shape (L 2048, D 128, bf16), measured on the card
     (each kernel's variants timed one kernel at a time; every time and
     the pick printed), then phase 7's Adafactor run with the picked
     tiles, which Llama's flash path reads from the cache, and again with
     every kernel's second variant: losses within ``TUNED_LOSS_RTOL`` of
     the untuned run's (the defaults to the bit's limit), every flash
     launch at the cached tiles and as many as the path's count; the
     cache is emptied after;
  8. training oracle on the card: bench widths, 2 layers, fp32, B 1 x L
     256: loss and every gradient with the flash kernels against plain
     full attention;
  9. the optimizer on the card: three Adafactor steps on a small fp32
     tree (factored and full second moments) against the same steps on
     the CPU;
 10. Mixtral training: ``make_train_step`` over the Mixtral ``loss_fn`` at
     Mixtral-8x7B's widths (vocab 32000, dim 4096, 32 q / 8 kv heads, ffn
     14336, 8 experts, top-2, rope theta 1e6) cut to 2 of 32 layers
     (3,033,616,384 parameters, 919,687,168 active), fp32 master weights
     from seed 0, bf16 compute, ``Adafactor(lr=1e-3)``, B 4 x L 2048 from
     seed 1: 2 warm-up and 3 timed steps with remat "full" (the JAX
     default), then 3 with "selective" (the first untimed), every port
     launch counter set to 0 just before and read just after (the JAX
     Mixtral runs no Pallas kernel, so all must stay 0); step time,
     tokens/s, MFU on active parameters, peak memory, the MoE's host
     reads, tokens per expert per layer, the step profiler's phases, and
     one step under torch.profiler split into expert products, dispatch,
     attention, router and the rest; then the same model's bf16 routing
     against its own fp32 forward (B 1 x L 512), which must agree on
     every token whose fp32 2nd/3rd probability gap exceeds
     ``ROUTING_MARGIN``, and a small fp32 Mixtral on the card against the
     CPU (loss, aux, routing, every gradient);
 11. RL on the card: the port's local-mode runtime
     (``ray_tpu_torch.init(local_mode=True, num_cpus=4)``), then PPO,
     IMPALA and DQN on CartPole and SAC on Pendulum at the JAX tests'
     settings (tests/test_rllib.py), each ``build(device="cuda")`` and
     ``train()``ed until the JAX test's gate on the best episode-return
     mean, every port launch counter set to 0 before and read after (all
     must stay 0: no Pallas kernel lies on this path); per algorithm the
     iteration ms split into sampling and the learner update, the update
     alone, one profiled update's device busy share, the check that a
     runner's weights do not move with the learner's, and one update of
     a fresh learner on the card against the CPU (fp32, each leaf within
     1e-5 of its largest value);
 12. data, batch inference and BC on the card, in the port's local mode:
     12a. ``batch_inference`` at the main path's widths (phase 4's model
     and engine: Llama-3-8B, all 32 layers, bf16, random weights from the
     engine's seed) over 16 rows made with ``data.from_items`` (prompts
     of 5 to 1,000 tokens) in 4 blocks through ``ActorPoolStrategy(1)``,
     32 new tokens each: the ragged launches, counted from 0, must equal
     the pool's engine's count as phase 4 computes it, the plain version
     must never run on CUDA tensors, every row must come back with its id
     and prompt and with 32 tokens or a stop, and equal
     ``LLMBatchPredictor`` called directly on the same blocks with the
     same weights (built once the pool's engine is gone); rows/s,
     generated tokens/s, the stage's ExecStats and both peaks printed;
     12b. the same at the bench widths in fp32 through
     ``ActorPoolStrategy(2)``: every row's tokens and finish reason equal
     ``generate`` on that prompt alone, both engines' launches counted;
     12c. BC: a PPO teacher (phase 11's PPO) to its gate,
     ``record_dataset`` of 8192 rows (obs fp32, action int32), then
     ``BCConfig(dataset, lr 1e-3, batch 512, seed 11).build(device=
     "cuda")`` to a best mean of 100 within 15 iterations
     (tests/test_rllib.py:239), every port launch counter at 0, the
     epoch's time split into batch iteration and learner updates, and one
     BC update on the card against the CPU (each leaf within 1e-5);
 13. Tune's Population Based Training over the train step:
     ``make_train_step`` over ``loss_fn`` at phase 7's widths cut to 2 of
     its 8 layers, fp32 master weights from seed 0, bf16 compute,
     ``Adafactor(lr=cfg["lr"])``, B 2 x L 2048 from seed 1; 4 trials with
     lr 1e-3, 1e-3, 3e-1, 3e-1, 2 at once, 4 reports of 2 steps each, a
     checkpoint (params and Adafactor state) at every 2nd report; PBT
     (perturbation interval 2, quantile 0.5, lr resampled from
     loguniform(1e-4, 3e-3), seed 0) on the loss; the flash launches,
     counted from 0, must equal the count for the steps the trials ran
     (re-runs after a restore included), trial 0's first two losses a
     standalone run's, each exploited trial's first loss its donor's at
     that iteration (1e-6 of itself), and both lr-3e-1 trials must end
     lower than their last loss before their exploit; checkpoint bytes,
     pickling and loading seconds, each trial's step ms against one
     alone, and the peak memory printed.
 14. the cluster runtime on the card, after phase 13 with the driver's
     engines freed: 14a. ``ray_tpu_torch.init(num_cpus=4)`` boots a head,
     a node daemon and the shm store as processes (boot time printed);
     the node counts the card itself (``GPU`` 1), and neither daemon
     holds a CUDA context (nvidia-smi's compute processes and their
     /proc maps and open files); 14b. a ``num_gpus=1`` actor builds phase
     4's server (Llama-3-8B widths, 32 layers, bf16, random weights from
     the engine's seed) in its worker process, which sees only card "0"
     through ``CUDA_VISIBLE_DEVICES``, and answers phase 4's requests:
     every token stream must equal phase 4's, and the worker's ragged
     launches, counted from 0 after construction and read through the
     actor, must equal the engine's count as phase 4 computes it (the
     driver's counters stay 0); the actor's creation time, each request's
     wall time beside phase 4's, the worker's peak memory and nvidia-smi's
     line for it printed; 14d. tensors from the worker's card (bf16,
     fp32, a strided view) nested in a dict arrive as CPU tensors equal
     byte for byte to ``.cpu()`` in the worker, and a 1 GiB CPU tensor
     goes through the shm store twice, the first freed before the second
     (put, get and a worker's read, GB/s); 14c. a second ``num_gpus=1``
     actor stays pending while the first holds the card; killing the
     first ends its process and frees its device memory, and the second
     places and answers phase 4's requests with phase 4's streams and the
     engine's ragged count; 14e. PPO at phase 11's settings, the learner
     on the card, with its env runners as worker processes that sample on
     their CPUs, to the JAX test's gate; then, to split that change into
     its two parts, the runner processes on the card, and after
     ``shutdown()`` the local mode's thread runners on the CPU and on the
     card: each run's iteration split into sampling and update.
 15. Serve on the card, on a fresh cluster (``init(num_cpus=4)``): 15a.
     phase 4's server, as a small ``LLMServer`` subclass, deployed
     through ``serve.run`` with the replica resources that
     ``build_llm_app(MAIN_MODEL, MAIN_ENGINE)`` derives ({"GPU": 1}): the
     replica runs in the card's dedicated worker (``CUDA_VISIBLE_DEVICES``
     "0", the node's GPU all booked); 15b. phase 4's first wave through
     the deployment handle, each request from its own thread under its
     own trace, admitted at one engine step (``hold``): every stream must
     equal phase 4's; 15c. phase 4's prefix-hit request alone through the
     HTTP proxy's ``/v1/completions`` (SSE), whose deltas must equal phase
     4's hit stream, and one ``/v1/chat/completions`` request (its OpenAI
     shape and usage counts); 15d. the replica's ragged launches, counted
     from 0 after construction, equal the engine's count, none of the
     plain version on CUDA, and every request's flight-recorder record
     reaches the head's ``requests_dump`` finished, with its caller's
     trace id (the handle's requests) and the worker and node that served
     it; 15e. ``serve.delete`` and ``serve.shutdown()`` end the replica's
     process and return the card's free memory. The deployment time, the
     lease, each request's wall time beside phase 4's and the phase's
     time printed.
 16. the device mesh and distributed training: 16a. the three flash
     kernels at one rank's shard of phase 7's shape (dp 2: B 4 x 24
     heads; tp 2: 12 q heads over 6 kv; tp 4: 6 over 3; L 2048, D 128,
     bf16, causal), each against its plain version with phase 6's limits,
     a planted causal fault failing on every query tile, and their times
     beside phase 6's; 16b. a fresh ``init(num_cpus=4)`` and
     ``TorchTrainer(ScalingConfig(num_workers=1, use_gpu=True,
     mesh=MeshSpec(fsdp=-1)))``: the worker leases the card, joins an NCCL
     group of world size 1 and runs phase 7 (its widths, seeds, batch,
     Adafactor and steps) on parameters sharded by ``param_specs``; each
     loss must equal phase 7's (rel 1e-5), the worker's flash launches
     (reported through ``train.report``) the path's count with none of the
     plain versions; step time, tokens/s, MFU and peak memory beside phase
     7's; 16c. the same widths at 1 layer, a checkpoint (parameters and
     Adafactor state) every step, the worker's ``os._exit`` after step 1
     of 3,
     ``FailureConfig(max_failures=1)``: the restarted worker restores the
     last checkpoint and its losses must equal an uninterrupted run's
     (rel 1e-6), and the card's free memory must be back to the byte
     (this process's view before and after the run; each worker's
     view at its start is printed only);
     the checkpoint's files, bytes and seconds to write and to read.
 17. the parallel axes left: 17a. phase 4's server with a tp=2 engine,
     both shards on the card (``TP_DEVICES``: one engine process drives
     every shard, as the JAX package's does), phase 4's requests (the wave
     admitted at one step, the prefix hit twice): each stream equal to
     phase 4's, or, where it parts, its first divergent step named with
     the tp=1 model's top-2 margin there under the logits' bf16 noise;
     the ragged launches 2 x phase 4's (one call per shard per layer);
     set-up, wave and hit times and peak memory beside phase 4's; then
     the ragged kernel against its plain version at a tp 2 and a tp 4
     shard's geometry (Hq 16 / Hkv 4 and Hq 8 / Hkv 2, phase 3's checks
     and times); 17b. a tp=4 engine at 8B widths (2 layers), each shard's
     attention in every call held against the plain version at the
     shard's geometry; 17c. the ring's per-rotation work
     (``ring_rotation``: a flash block + the lse merge) for every virtual
     rank of rings of 2 and 4 ranks (B 1, H 24, blocks of 2048, D 128,
     bf16, causal), the blocks in the ring's order: output and gradients
     against one whole-sequence ``flash_attention`` within phase 6's
     limits, the flash launches of the pass (10 of each kernel at 4
     ranks), and the diagonal and off-diagonal rotation timed beside the
     whole-sequence call.
 18. the DAGs, the RL learners on a mesh and the compile tracker: 18a. a
     compiled pure-function DAG (``dag.experimental_compile``) around one
     flash forward at phase 6's shape: a projection of the input into k
     and v (one bf16 matmul), the flash forward with the input as the
     queries (it reads the input and the projection: a diamond), and an
     output projection, captured once in a CUDA graph and replayed 50
     times and more: the replay equal to the stages run eagerly to the
     bit, the flash stage within phase 6's limits of the plain version, a
     result kept from the first execute unchanged by the second, the
     flash launches, counted from 0, equal to captures + replays; the
     capture time and the replay and eager ms (calls back to back)
     printed; 18b. the compiled actor DAG of
     tests/test_jobs_dag_workflow.py on a fresh ``init(num_cpus=2)``: two
     actors chained through shm channels, ordering over 20 executions,
     an error through the channel, and the JAX test's criterion, compiled
     >= 2x eager chained calls at N 200 (both rates printed), then
     ``teardown``; 18c. PPO, IMPALA and BC (phase 11's and 12c's
     settings) through ``build(mesh=)`` on a one-rank NCCL mesh in the
     local mode: one update of each equal to the bit to
     ``build(mesh=None)``'s on the same batch, then one ``train()`` on the
     mesh; 18d. (run right after phase 4) the compile tracker's records
     of the engine's step functions (``llm.*``) equal phase 4's step
     programs (at most 3), no ``llm_compile_invariant_breach`` staged;
     phase 4's first wave on phase 4's engine (prefix cache off) in turns
     with the tracker's wraps on and off: equal streams, no new record,
     the ragged launches the engine's count, both wall times printed.
 19. the cluster's operations surface: 19a. a multi-node ``Cluster``
     (``cluster_utils``): a head, a head node and node A with no card,
     node B with the card (``resources={"GPU": 1}``; the others advertise
     none), no daemon holding CUDA; 19b. ``JobSubmissionClient`` runs an
     entrypoint that connects through ``RTPT_ADDRESS``, reserves
     ``{"GPU": 1, "CPU": 1}`` in a STRICT_PACK placement group and serves
     phase 4's requests from phase 14's server (full 8B) in bundle 0: the
     job ends SUCCEEDED, the bundle is on node B, the streams equal phase
     4's to the bit, the worker's ragged launches the engine's count
     (added to the kernels' record); 19c. ``python -m ray_tpu_torch``
     status, list nodes, list actors, top (node B's card memory), requests
     (the wave's records and TTFTs), trace --request and logs --request,
     each exiting 0 and timed; the dashboard's state (the three nodes, the
     group) and ``/metrics`` (node B's ``gpu_memory_used_bytes``, the
     ``llm_*`` series); 19d. ``remove_placement_group`` ends the worker
     and the card's free memory returns to the phase's start; 19e. an
     ``AutoscalingCluster`` (a head node with no card, node types cpu and
     h100): a pending ``[{"GPU": 1}]`` bundle launches one h100 node and
     no cpu node, the server at 8B widths with 2 layers answers one
     request with a direct engine's tokens, and once the group is removed
     idle drain terminates the node (its record through TERMINATED, its
     daemon gone); 19f. the cloud provider: an ``Autoscaler`` (a head
     node with no card) over ``GceGpuNodeProvider`` for a3-highgpu-1g,
     whose Compute transport is a fake that runs each inserted
     instance's own startup script with bash on card 0 (the stand-in VM)
     and answers GETs from that process: a pending ``[{"GPU": 1,
     "GPU-H100": 1}]`` bundle drives exactly one insert, the node
     registers with the ``GPU-H100`` key it read from the card's name,
     the 2-layer server in the bundle answers a direct engine's tokens
     with the engine's ragged launches (added to the kernels' record),
     and removing the group gives one DELETE of that instance, the
     process gone, ``list_live()`` empty and the card's memory back.
     Boot, submit-to-SUCCEEDED, group ready, each CLI call, scale-up,
     insert-to-registration and drain times printed.
 20. several cards (each sub-phase logs a line that skips it when
     ``torch.cuda.device_count()`` is below what it needs; rank programs
     run through ``TorchTrainer(use_gpu=True)``, one leased worker and
     card each in an NCCL group, and each parity case against the same
     program over gloo CPU ranks at the gloo tests' limits): 20a. the
     group on 2 and 4 cards and a re-join in the same processes; 20b.
     every collective over every mesh axis and axis pair, forward and
     backward, and the bus bandwidth at 256 MB of bf16; 20c. the sharded
     train step on dp 2, fsdp 2, tp 2, dp 2 x fsdp 2, fsdp 2 x tp 2 and
     the prefetching fsdp step; 20d. Llama-3-8B FSDP over 4 cards ((8,
     2048) tokens, Adafactor, flash, selective remat): a 2-layer fp32
     check against one card, then 32 layers with plain and prefetched
     gathers (step ms, tokens/s, MFU a card, peak a card, NCCL time and
     its share under compute) and the flash kernels at a rank's shape;
     20e. the fused ring, Ulysses, pp 2 and dp 2 x ep 2, and the ring's
     forward at L 8192 against one flash call; 20f. 20d's checkpoint on
     2 cards, a killed rank resumed on 3, a grow from 2 to 4, and a
     group whose peer stays away ended within its timeout; 20g. phase
     4's server at tp=4 with a shard on each card; 20h. phase 13's PBT
     with a card per trial.
 21. the engine under memory pressure, Llama-3-8B widths, all 32 layers,
     phase 4's weights drawn once and handed to every engine: 21a. phase
     4's server, requests and checks with an int8 pool in the bytes of
     phase 4's bf16 pool (pages and their ratio, at least 1.9), its
     ragged launches all on int8 pools (counted apart) and the engine's
     step count, each stream equal to phase 4's up to a parting where the
     bf16 forward's top-2 margin is under INT8_MARGIN_FLOOR or twice the
     bf16 noise (most of the wave's tokens compared), the kernel against
     its plain version on the engine's live quantized pools in every
     layer (2^-7 of each row's scale), the prefix hit under the profiler;
     then with bf16 and with int8 pools: 21b. a request whose prompt is
     the published 256-token prefix: one copy-on-write, the copy equal to
     its source to the bit (slots 0-14 still after the request), the
     stream against no prefix cache; 21c. after the wave on a 128-page
     pool, a 1500-token prompt admitted by evicting cached pages, its
     stream against the full pool's; 21d. the wave on a 68-page pool that
     its decode outgrows: preemptions, none finished "evict", the flight
     recorder's preempts and stalls, the gauge, every stream against the
     uncontended run's; 21e. phase 17a's tp=2 server over int8 pools on
     the one card, held against 21a by TP_MARGIN_FLOOR's rule, its int8
     launches twice 21a's. Every stream comparison under the margin rule,
     every engine's launches its step count;
 22. the runtime's failures with card workers: 22a phase 4's server as a
     named detached ``num_gpus=1`` actor behind a head started with a
     persist path, the head SIGKILLed and restarted on its address, the
     node re-registering and handing the actor over: its streams equal
     before and after and to phase 4's, its launches its steps, a second
     card actor pending until the survivor's kill, the card's memory
     back; 22d (while 22a serves, profiles on) the worker's
     gpu_memory_used_bytes at the head within three export periods and
     equal to its memory_allocated at a quiet point, a print with its pid
     at the driver, the methods' spans under one trace, a burst capture
     naming a step function; 22b a card task's flash forward (phase 6's
     shape) rebuilt through lineage after its primary is deleted, equal
     to the bit and within flash's limit of the plain version, puts past
     an arena of 2.5 outputs spilled and read back, a spilled output as a
     card task's argument, a spilled output rebuilt after its spill file
     is deleted; 22c a per-worker RSS cap above the card worker's RSS
     measured in 22b: a hog's OutOfMemoryError, the card's memory and GPU
     back, the cause in the journal, the retry on the card, an actor's
     worker_death then actor_restarting under one trace id; 22e (two
     cards) tests/test_train_straggler.py's program a rank a card, a
     flash forward and backward a step: one train_straggler event naming
     host 1, the skew gauges.
Each phase from 12 on prints its time, and the script its whole time.
The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# kernel vs plain, held per (token, head) against that row's own scale
# (a token that sees n slots has outputs of about sqrt(e / n)):
# |got - ref| <= KERNEL_RTOL * max|ref| + KERNEL_FLOOR. Both sides round
# fp32 values that differ by summation order to bf16, so they differ by
# at most one bf16 step of the row's largest value, 2^-7 of it.
KERNEL_RTOL = 2.0 ** -7
KERNEL_FLOOR = 1e-5
# the library yardstick works in bf16 inside (probabilities included), so
# it is held only to being the same function, not to the kernel's bound
LIBRARY_ATOL = 5e-2
# decode op vs plain, per (sequence, head) against the row's own scale.
# bf16: the ragged kernel's limit. The kernel's splits round p to bf16
# against their own running maximum, the single walk against its own, and
# the gather version not at all; each of these moves an fp32 output by
# less than a bf16 step, so the outputs' roundings differ by at most one
# step, as for summation order. One step at the row's largest value m
# reads 2^-7 m / (2^-7 m + 1e-5): just under 1 where m is about 1, as on
# the engine's live pools; only fp32 outputs a whole step apart could
# pass 1. fp32: summation order and the merge's exponentials only.
DECODE_TOL = {torch.float32: (1e-5, 1e-6),
              torch.bfloat16: (KERNEL_RTOL, KERNEL_FLOOR)}
# fp32 engine vs fp32 full forward: logits differ by summation order only
FP32_LOGIT_NOISE = 1e-3
# flash kernels vs plain, bf16, per row against the row's own scale: one
# bf16 step for the outputs' rounding (2^-7 of the row's largest value),
# and one more because the forward's 128-key tiles and the plain
# version's 256-key blocks rescale p by different running maxima before
# rounding it to bf16 (the plain version at the kernels' tiles against its
# 256-row blocks is held to this limit on the CPU,
# tests/test_torch_flash_attention.py); the gradients' L-term sums in
# another order add fp32 noise far below that
FLASH_RTOL = 2.0 ** -6
# lse is fp32 from the same scores: a sum of L <= 2048 terms in another
# order moves l by at most L * 2^-24 ~ 1.2e-4 relative, lse by as much
LSE_ATOL = 2.0 ** -12
# training oracle, fp32 flash kernels vs plain full attention: gradients
# per leaf within 5e-5 of the leaf's largest value, loss within 1e-5 of
# itself (about 30x the 1.7e-6 and 1e-7 seen on the CPU at reduced width)
TRAIN_ORACLE_RTOL = 5e-5
TRAIN_ORACLE_LOSS_RTOL = 1e-5


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------ measurement


def tolerance_ratios(got, ref):
    """|got - ref| / (KERNEL_RTOL * max|ref| + KERNEL_FLOOR), worst over
    the head dim, per (token, head): [T, H]. At most 1 passes."""
    err = (got.float() - ref.float()).abs().amax(-1)
    return err / (KERNEL_RTOL * ref.float().abs().amax(-1) + KERNEL_FLOOR)


def flash_ratios(got, ref):
    """|got - ref| / (FLASH_RTOL * max|ref| + KERNEL_FLOOR) per row of
    [BH, L, D] tensors: [BH, L]. At most 1 passes."""
    err = (got.float() - ref.float()).abs().amax(-1)
    return err / (FLASH_RTOL * ref.float().abs().amax(-1) + KERNEL_FLOOR)


def decode_ratios(got, ref):
    """|got - ref| / (rtol * max|ref| + floor) per (sequence, head) of
    [B, Hq, D] outputs, the limits by ref's dtype (DECODE_TOL): [B, Hq].
    At most 1 passes."""
    rtol, floor = DECODE_TOL[ref.dtype]
    err = (got.float() - ref.float()).abs().amax(-1)
    return err / (rtol * ref.float().abs().amax(-1) + floor)


def time_ms(fn, iters=10, flush=None, clean=False):
    """Mean device time of fn() over iters calls, CUDA events around each
    call only; ``flush`` (a large tensor) is rewritten before each call
    so the 50 MB L2 holds none of the inputs, as in the engine, where
    every layer reads another slice of the pool. Rewriting it leaves the
    L2 full of dirty lines, whose write-back a call that reads much pays
    for; with ``clean`` the flush reads the tensor instead, leaving clean
    lines (the kernel times chip_smoke.py prints are taken without it).
    A spin kernel of about 1 ms then keeps the device busy while the host
    records the start event and enqueues the call, so a call whose host
    side (checks, allocations, ctypes: tens of microseconds per wrapper
    call) outlasts the flush is not charged for it: the time is the
    device's."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.sum() if clean else flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def attention_bound_ms(q, k_pages, q_len, kv_len, token_vis, scales):
    """Least time for ragged attention on these inputs: each active row's
    visible K/V (and int8 scales) read once, q read and o written once,
    over HBM bandwidth; or 4 * vis * Hq * D FLOP per token at the bf16
    tensor-core peak. Returns (ms, "bytes" | "operations")."""
    T, Hq, D = q.shape
    _, Hkv, _, _ = k_pages.shape
    kv_slots = int(kv_len[q_len > 0].sum())
    nbytes = 2 * kv_slots * Hkv * D * k_pages.element_size()
    if scales:
        nbytes += 2 * kv_slots * Hkv * 2
    nbytes += 2 * q.numel() * q.element_size()
    flops = 4 * int(token_vis.long().sum()) * Hq * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_instantiations(build_log, kernel):
    """What ``-Xptxas -v`` says of each instantiation of a kernel template:
    [(its template arguments as the mangled name gives them, e.g. "128,
    2" or "64, 4, 1", its lines joined)]."""
    out, inside = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
            if inside:
                args = re.search(kernel + r"I(.*?)EEv", line)
                out.append((", ".join(re.findall(r"L[ib](\d+)E",
                                                 args.group(1) + "E"))
                            if args else "", []))
        elif inside and ("spill" in line or "Used" in line):
            out[-1][1].append(line.replace("ptxas info    :", "").strip())
    assert out and all(lines for _, lines in out), \
        f"no ptxas report for {kernel}"
    return [(args, "; ".join(lines)) for args, lines in out]


def flash_variant_smem():
    """Each built flash tile's dynamic shared memory as its library counts
    it ({(dtype, D, kernel, tile): bytes}), held equal to the tuner's model
    (``_est_smem_bytes``)."""
    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.ops import flash_attention as tfa
    fwd = _kernels.load("flash_attention_fwd")
    bwd = _kernels.load("flash_attention_bwd")
    out = {}
    for (dtype, D), table in tfa.KERNEL_TILES.items():
        code = tfa._DTYPE_CODES[dtype]
        for kernel, tiles in table.items():
            for tile in tiles:
                got = (fwd.flash_attention_fwd_smem(code, D, *tile)
                       if kernel == "fwd" else bwd.flash_attention_bwd_smem(
                           int(kernel == "dkv"), code, D, *tile))
                want = tfa._est_smem_bytes(kernel, *tile, D, dtype)
                assert got == want, (dtype, D, kernel, tile, got, want)
                out[dtype, D, kernel, tile] = got
    return out


def ptxas_report(build_log, kernel):
    """What ``-Xptxas -v`` says of one kernel (the entries whose mangled
    name holds ``kernel``): for one entry its lines joined (stack and
    spill bytes, registers and barriers); for a template built several
    times, the number of entries, the range of their registers and the
    largest spill and stack bytes."""
    entries, inside = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
            if inside:
                entries.append([])
        elif inside and ("spill" in line or "Used" in line):
            entries[-1].append(line.replace("ptxas info    :", "").strip())
    assert entries and all(entries), f"no ptxas report for {kernel}"
    if len(entries) == 1:
        return "; ".join(entries[0])

    lines = sum(entries, [])

    def most(pattern, lines):
        return max(int(m) for ln in lines for m in re.findall(pattern, ln))
    regs = [most(r"Used (\d+) registers", e) for e in entries]
    stack = most(r"(\d+) bytes stack", lines)
    stores = most(r"(\d+) bytes spill stores", lines)
    loads = most(r"(\d+) bytes spill loads", lines)
    return (f"{len(entries)} instantiations, {min(regs)}-{max(regs)} "
            f"registers, at most {stack} bytes stack, {stores} bytes spill "
            f"stores, {loads} bytes spill loads")


# ---------------------------------------------------- phase 3: the kernel


def mixed_batch(device, Hq=32, Hkv=8, D=128, ps=16, P=512, max_pages=128,
                decode_lens=(1, 17, 100, 333, 512, 700, 1000, 1500),
                chunks=((512, 188), (300, 0)), capacity=8 + 2 * 512,
                seed=0):
    """A ragged batch with the main path's geometry (8 decode slots, two
    prefill rows of up to 512 tokens, 1032 tokens): one decode row per
    slot (slot 6 inactive, q_len 0), then prefill chunks of (tokens,
    prefix tokens) — the first straddles pages after its prefix, the
    second leaves the end of the token capacity to padding."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = [(i, 0 if i == 6 else 1, n) for i, n in enumerate(decode_lens)]
    t0 = len(decode_lens)
    for c, pre in chunks:
        rows.append((t0, c, c + pre))
        t0 += c
    assert t0 <= capacity
    perm = torch.randperm(P - 1, generator=g, device=device) + 1
    pt = torch.zeros(len(rows), max_pages, dtype=torch.int32, device=device)
    used = 0
    for r, (_, _, L) in enumerate(rows):
        npg = -(-L // ps)
        pt[r, :npg] = perm[used:used + npg]
        used += npg
    desc = [torch.tensor(x, dtype=torch.int32, device=device)
            for x in zip(*rows)]
    q = torch.randn(capacity, Hq, D, generator=g, device=device).bfloat16()
    kp = torch.randn(P, Hkv, ps, D, generator=g, device=device).bfloat16()
    vp = torch.randn(P, Hkv, ps, D, generator=g, device=device).bfloat16()
    return q, kp, vp, pt, *desc


def sdpa_inputs(q, kp, vp, pt, q_start, q_len, kv_len, k_scale, v_scale):
    """K/V gathered into contiguous padded rows, q padded per row, and the
    ragged causal mask, for one ``scaled_dot_product_attention`` call
    computing the same function (built once, not timed)."""
    from ray_tpu_torch.ops.paged_attention import _token_descriptors
    Hq, D = q.shape[1], q.shape[2]
    Hkv, ps = kp.shape[1], kp.shape[2]
    rows = [r for r in range(len(q_len)) if int(q_len[r]) > 0]
    C = max(int(q_len[r]) for r in rows)
    Lk = max(int(kv_len[r]) for r in rows)
    qpad = torch.zeros(len(rows), Hq, C, D, dtype=q.dtype, device=q.device)
    ks = torch.zeros(len(rows), Hkv, Lk, D, dtype=q.dtype, device=q.device)
    vs = torch.zeros_like(ks)
    mask = torch.zeros(len(rows), 1, C, Lk, dtype=torch.bool,
                       device=q.device)
    for i, r in enumerate(rows):
        s0, n, L = int(q_start[r]), int(q_len[r]), int(kv_len[r])
        qpad[i, :, :n] = q[s0:s0 + n].transpose(0, 1)
        pages = pt[r, :-(-L // ps)].long()
        for dst, pool, sc in ((ks, kp, k_scale), (vs, vp, v_scale)):
            x = pool[pages].float()
            if sc is not None:
                x = x * sc[pages].float()[..., None]
            x = x.permute(1, 0, 2, 3).reshape(Hkv, -1, D)[:, :L]
            dst[i, :, :L] = x.to(q.dtype)
        j = torch.arange(n, device=q.device)[:, None]
        mask[i, 0, :n, :L] = torch.arange(L, device=q.device)[None, :] \
            < (L - n + j + 1)
    _, token_vis = _token_descriptors(q_start, q_len, kv_len, q.shape[0])
    return qpad, ks, vs, mask, rows, token_vis


def ragged_profile(fn, device, ms, flush):
    """One call of fn under the profiler, the L2 flushed before it: the
    ragged kernels' CUDA launches and device time. A window that records
    no device activity (seen once in a run of several) is taken again."""
    for _ in range(3):
        flush.zero_()
        _, summary = profile_device(fn, device, ms, focus=("ragged",))
        if "ragged x0 " not in summary:
            break
    return summary


def phase_kernel(device, geometry=None):
    """The ragged kernel against its plain version on the mixed batch (bf16
    and int8 pools) and the decode batch, at the main path's geometry or
    at ``geometry`` (Hq, Hkv, D, ps), with planted faults, times, and (at
    the main path's geometry only) other split sizes and the profiler."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops import paged_attention as tpa
    from ray_tpu_torch.ops.int8 import quantize_kv

    extras = geometry is None
    geometry = geometry or {}
    tag = "".join(f" {k}={v}" for k, v in geometry.items())
    q, kp, vp, pt, qs, ql, kl = mixed_batch(device, **geometry)
    T = q.shape[0]
    owned = torch.zeros(T, dtype=torch.bool, device=device)
    for s, n in zip(qs.tolist(), ql.tolist()):
        owned[s:s + n] = True
    # the engine's hints: its max_batch decode rows, chunks of up to 512
    hints = dict(decode_rows=MAIN_ENGINE["max_batch"], max_q_len=512)
    prefill_rows = torch.arange(len(ql), device=device) >= hints[
        "decode_rows"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    ksc8, vsc8 = None, None
    out = {}
    for pools in ("bf16", "int8"):
        if pools == "int8":
            k, ksc8 = quantize_kv(kp)
            v, vsc8 = quantize_kv(vp)
        else:
            k, v = kp, vp
        sc = dict(k_scale=ksc8, v_scale=vsc8) if pools == "int8" else {}
        got = tpa.ragged_paged_attention(q, k, v, pt, qs, ql, kl, **sc,
                                         **hints)
        ref = tpa.ragged_paged_attention_reference(q, k, v, pt, qs, ql, kl,
                                                   **sc, **hints)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        ratio = tolerance_ratios(got, ref).max().item()
        assert torch.isfinite(got).all(), f"{pools}: non-finite output"
        assert ratio <= 1, f"{pools}: kernel vs plain at {ratio} x the limit"
        assert bool((got[~owned] == 0).all()), f"{pools}: padding not 0"
        # planted prefill fault: each prefill token drops its last visible
        # slot; every prefill token must then fail the check on some head.
        # Not every (token, head): a head whose dropped slot had a tiny
        # probability moves by less than the limit; their share is logged
        fault = tpa.ragged_paged_attention_reference(
            q, k, v, pt, qs, ql, kl - prefill_rows.int(), **sc, **hints)
        pre = torch.zeros_like(owned)
        for s, n in zip(qs[prefill_rows].tolist(), ql[prefill_rows].tolist()):
            pre[s:s + n] = True
        caught = tolerance_ratios(fault, ref)[pre]          # [tokens, Hq]
        assert bool((caught.amax(-1) > 1).all()), \
            f"{pools}: prefill fault not caught: {caught.amax(-1).min()}"
        log(f"planted fault ({pools}: each prefill token drops its last "
            f"slot): all {caught.shape[0]} prefill tokens fail, the weakest "
            f"at {caught.amax(-1).min().item():.1f} x the limit; "
            f"{(caught > 1).float().mean().item():.1%} of their (token, "
            f"head) pairs fail")
        kern_ms = time_ms(lambda: tpa.ragged_paged_attention(
            q, k, v, pt, qs, ql, kl, **sc, **hints), flush=flush)
        plain_ms = time_ms(lambda: tpa.ragged_paged_attention_reference(
            q, k, v, pt, qs, ql, kl, **sc, **hints), iters=3, flush=flush)
        launches = ragged_profile(lambda: tpa.ragged_paged_attention(
            q, k, v, pt, qs, ql, kl, **sc, **hints), device, kern_ms,
            flush) if extras else "not taken"
        sweep = {n: round(time_ms(lambda: tpa._ragged_attention_cuda(
            q, k, v, pt, qs, ql, kl, ksc8, vsc8, q.shape[-1] ** -0.5,
            pages_per_split=n, **hints), flush=flush), 4)
            for n in ((4, 16, 32) if extras else ())}
        sq, sk, sv, mask, rows, token_vis = sdpa_inputs(
            q, k, v, pt, qs, ql, kl, ksc8, vsc8)
        lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                                 enable_gqa=True)
        for i, r in enumerate(rows):
            s0, n = int(qs[r]), int(ql[r])
            lib_err = (lib_out[i, :, :n].transpose(0, 1).float()
                       - ref[s0:s0 + n].float()).abs().max().item()
            assert lib_err <= LIBRARY_ATOL, \
                f"SDPA yardstick differs {lib_err}"
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask, enable_gqa=True), flush=flush)
        bound_ms, bound_by = attention_bound_ms(q, k, ql, kl, token_vis,
                                                pools == "int8")
        log(f"ragged_paged_attention{tag} {pools} pools T={T} rows="
            f"{len(kl)}: "
            f"max_abs_err {err:.3e}, worst {ratio:.3f} x the tolerance, "
            f"kernel {kern_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f}"
            f" ms ({bound_by}); kernel ms with other pages_per_split: "
            f"{sweep}; one call under the profiler: {launches}")
        out[pools] = dict(max_abs_err=err, ms=kern_ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
    # the decode loop's shape: 8 decode rows, T == R == 8
    dq, dk, dv, dpt, dqs, dql, dkl = mixed_batch(device, chunks=(),
                                                 capacity=8, **geometry)
    dhints = dict(decode_rows=8, max_q_len=1)   # as ragged_decode_loop
    dgot = tpa.ragged_paged_attention(dq, dk, dv, dpt, dqs, dql, dkl,
                                      **dhints)
    dref = tpa.ragged_paged_attention_reference(dq, dk, dv, dpt, dqs, dql,
                                                dkl)
    derr = (dgot.float() - dref.float()).abs().max().item()
    dratio = tolerance_ratios(dgot, dref).max().item()
    assert dratio <= 1, f"decode shape: kernel vs plain at {dratio} x"
    # the tolerance's margin against a planted fault: each decode row
    # loses its last visible slot (an off-by-one); every row must then
    # fail the check, the 1500-slot row included
    fault = tpa.ragged_paged_attention_reference(dq, dk, dv, dpt, dqs, dql,
                                                 dkl - 1)
    rows = ((dql > 0) & (dkl > 1)).nonzero().flatten()
    caught = tolerance_ratios(fault, dref).amax(-1)[rows]
    assert bool((caught > 1).all()), f"planted fault not caught: {caught}"
    log(f"planted fault (each decode row drops its last slot): rows of kv "
        f"{dkl[rows].tolist()} fail at "
        f"{[round(x, 1) for x in caught.tolist()]} x the tolerance")
    _, dvis = tpa._token_descriptors(dqs, dql, dkl, 8)
    dms = time_ms(lambda: tpa.ragged_paged_attention(
        dq, dk, dv, dpt, dqs, dql, dkl, **dhints), flush=flush)
    dlaunches = ragged_profile(lambda: tpa.ragged_paged_attention(
        dq, dk, dv, dpt, dqs, dql, dkl, **dhints), device, dms,
        flush) if extras else "not taken"
    dsweep = {n: round(time_ms(lambda: tpa._ragged_attention_cuda(
        dq, dk, dv, dpt, dqs, dql, dkl, None, None, dq.shape[-1] ** -0.5,
        pages_per_split=n, **dhints), flush=flush), 4)
        for n in ((4, 16, 32) if extras else ())}
    dplain = time_ms(lambda: tpa.ragged_paged_attention_reference(
        dq, dk, dv, dpt, dqs, dql, dkl), iters=3, flush=flush)
    dbound, dby = attention_bound_ms(dq, dk, dql, dkl, dvis, False)
    sq, sk, sv, mask, rows, _ = sdpa_inputs(dq, dk, dv, dpt, dqs, dql, dkl,
                                            None, None)
    lib_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                             enable_gqa=True)
    lib_err = (lib_out[:, :, 0].float()
               - dref[dqs[rows].long()].float()).abs().max().item()
    assert lib_err <= LIBRARY_ATOL, f"SDPA yardstick differs {lib_err}"
    dlib = time_ms(lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask, enable_gqa=True), flush=flush)
    log(f"ragged_paged_attention{tag} bf16 pools decode T=8: max_abs_err "
        f"{derr:.3e}, worst {dratio:.3f} x the tolerance, kernel "
        f"{dms:.4f} ms, plain {dplain:.4f} ms, sdpa {dlib:.4f} ms, bound "
        f"{dbound:.4f} ms ({dby}); kernel ms with other pages_per_split: "
        f"{dsweep}; one call under the profiler: {dlaunches}")
    del flush
    out["decode"] = dict(max_abs_err=derr, ms=dms, plain_ms=dplain,
                         library_ms=dlib, bound_ms=dbound, bound_by=dby)
    return out


# ------------------------------------------------- phase 3b: the decode op

# name: (seq_lens, max_pages, pool pages, pool dtypes, geometry). A: the
# serving config's decode batch (8 slots, max_seq_len 2048, a 512-page
# pool; 310 pages used). B: 8 sequences at Llama 3's 8192-token context.
# C: bench_llm.py's serving widths (Hq 16, Hkv 8, head dim 64, pages of
# 32; max_seq_len 512 and a 1024-page pool) at lengths around its edges.
BENCH_GEOMETRY = {"Hq": 16, "Hkv": 8, "D": 64, "ps": 32}
DECODE_BATCHES = {
    "A": ((1, 15, 16, 17, 300, 1024, 1500, 2048), 128, 512,
          (torch.bfloat16, torch.float32), {}),
    "B": ((8192,) * 8, 512, 4100, (torch.bfloat16,), {}),
    "C": ((1, 31, 32, 33, 128, 300, 500, 512), 16, 1024,
          (torch.bfloat16, torch.float32), BENCH_GEOMETRY),
}


def decode_batch(device, lens, max_pages, P, dtype, Hq=32, Hkv=8, D=128,
                 ps=16, seed=3):
    """One decode token per sequence at the main path's attention widths;
    each sequence's pages drawn without repeats from 1..P-1, the table's
    tail left at page 0 (the scratch page)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(len(lens), Hq, D, generator=g, device=device).to(dtype)
    kp = torch.randn(P, Hkv, ps, D, generator=g, device=device).to(dtype)
    vp = torch.randn(P, Hkv, ps, D, generator=g, device=device).to(dtype)
    perm = torch.randperm(P - 1, generator=g, device=device) + 1
    pt = torch.zeros(len(lens), max_pages, dtype=torch.int32, device=device)
    used = 0
    for b, n in enumerate(lens):
        npg = -(-n // ps)
        pt[b, :npg] = perm[used:used + npg]
        used += npg
    assert used < P
    return q, kp, vp, pt, torch.tensor(lens, dtype=torch.int32,
                                       device=device)


def decode_sdpa_inputs(q, kp, vp, pt, lens):
    """q as [B, Hq, 1, D], K/V gathered into contiguous [B, Hkv, L, D] (L
    the longest length) and the length mask [B, 1, 1, L]: one
    ``scaled_dot_product_attention`` call computing the decode op (built
    once, not timed)."""
    B, Hq, D = q.shape
    _, Hkv, ps, _ = kp.shape
    L = int(lens.max())
    pages = pt[:, :-(-L // ps)].long()
    ks, vs = (pool[pages].permute(0, 2, 1, 3, 4).reshape(B, Hkv, -1, D)
              [:, :, :L].contiguous() for pool in (kp, vp))
    mask = torch.arange(L, device=q.device)[None, :] < lens[:, None]
    return q[:, :, None], ks, vs, mask[:, None, None, :]


def phase_decode(device):
    """The decode op on batches A, B and C, split as ``decode_plan``
    says: the kernel against the split plain version (at the plan's split
    size) and the gather version, the planted fault, a length-0 row, two
    calls equal bit for bit, and the times of kernel, plain version and
    SDPA beside the bound, and of the kernel at other split sizes."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops import paged_attention as tpa

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {}
    for name, (lens, max_pages, P, dtypes, geometry) in \
            DECODE_BATCHES.items():
        for dtype in dtypes:
            key = f"{name} {str(dtype).split('.')[-1]}"
            q, kp, vp, pt, sl = decode_batch(device, lens, max_pages, P,
                                             dtype, **geometry)
            scale = q.shape[-1] ** -0.5
            # the split size the wrapper takes: decode_plan's, from shapes
            plan = tpa.decode_plan(q.shape[0], q.shape[1], kp.shape[1],
                                   max_pages, kp.shape[2])
            pps = plan.pages_per_split
            got = tpa.paged_attention(q, kp, vp, pt, sl)
            again = tpa.paged_attention(q, kp, vp, pt, sl)
            split = tpa._paged_decode_reference(q, kp, vp, pt, sl, scale,
                                                pps)
            gather = tpa.paged_attention_reference(q, kp, vp, pt, sl)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), f"{key}: non-finite output"
            assert torch.equal(got, again), f"{key}: calls differ"
            r_split = decode_ratios(got, split).max().item()
            r_gather = decode_ratios(got, gather).max().item()
            assert r_split <= 1 and r_gather <= 1, \
                f"{key}: kernel at {r_split} / {r_gather} x the limit"
            err = max((got.float() - ref.float()).abs().max().item()
                      for ref in (split, gather))
            # planted fault: every sequence drops its last slot; every row
            # longer than 1 slot must then fail the check
            fault = tpa._paged_decode_reference(q, kp, vp, pt, sl - 1,
                                                scale, pps)
            caught = decode_ratios(fault, split).amax(-1)[sl > 1]
            assert bool((caught > 1).all()), \
                f"{key}: planted fault not caught: {caught}"
            # a length-0 row comes back exactly 0, the others as before
            sl0 = sl.clone()
            sl0[0] = 0
            got0 = tpa.paged_attention(q, kp, vp, pt, sl0)
            assert bool((got0[0] == 0).all()), f"{key}: length 0 not 0"
            assert torch.equal(got0[1:], got[1:]), f"{key}: rows moved"
            ms = time_ms(lambda: tpa.paged_attention(q, kp, vp, pt, sl),
                         flush=flush)
            plain_ms = time_ms(lambda: tpa._paged_decode_reference(
                q, kp, vp, pt, sl, scale, pps), iters=3, flush=flush)
            # for the record: other splits (the path takes the plan's),
            # and the split and merge launches' device times
            sweep = {n: round(time_ms(lambda: tpa._paged_attention_cuda(
                q, kp, vp, pt, sl, scale, n), flush=flush), 4)
                for n in sorted({max(1, pps // 2), 2 * pps, 4, 8, 16, 32}
                                - {pps}) if n <= max_pages}
            flush.zero_()
            _, busy = profile_device(lambda: tpa.paged_attention(
                q, kp, vp, pt, sl), device, ms)
            sq, sk, sv, mask = decode_sdpa_inputs(q, kp, vp, pt, sl)
            lib_out = F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True)
            lib_err = (lib_out[:, :, 0].float() - gather.float()).abs() \
                .max().item()
            assert lib_err <= LIBRARY_ATOL, \
                f"{key}: SDPA yardstick differs {lib_err}"
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, enable_gqa=True), flush=flush)
            del sq, sk, sv, mask
            vis = sl.clamp(0, max_pages * kp.shape[2])
            bound, by = attention_bound_ms(q, kp, torch.ones_like(sl), vis,
                                           vis, False)
            log(f"paged_attention {key} pools B={len(lens)} Hq "
                f"{q.shape[1]} Hkv {kp.shape[1]} D {q.shape[2]} page "
                f"{kp.shape[2]} max_pages {max_pages} lens {list(lens)}: "
                f"worst {r_split:.3f} x the "
                f"limit against the split plain version, {r_gather:.3f} "
                f"against the gather version, max_abs_err {err:.3e}; "
                f"planted fault (each row drops its last slot) fails on "
                f"every row longer than 1, the weakest at "
                f"{caught.min().item():.1f} x the limit; length 0 gives 0; "
                f"two calls give the same bits; plan {tuple(plan)}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}); kernel "
                f"ms with other pages_per_split: {sweep}; one call under "
                f"the profiler: {busy}")
            out[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bound, bound_by=by)
            del q, kp, vp, pt, sl, got, again, split, gather, fault, got0
    del flush
    return out


def phase_decode_engine(model_config=None, engine_config=None):
    """The decode op on the engine's own decode steps. Two requests, the
    second hitting the first's 256-token prefix in the page cache, are
    served through ``InferenceEngine`` (Llama-3-8B widths, 2 layers, the
    main path's engine otherwise). Each decode-loop attention call (every
    batch slot one row of one token: decode_rows == R == T) also runs
    ``paged_attention`` on the same live pools, page table and lengths,
    held against the ragged kernel's output. The launch counters are set
    to 0 just before and read just after, and the decode op's launches
    must equal layers x decode steps; returns them."""
    from ray_tpu_torch.llm import model as M
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    from ray_tpu_torch.ops import paged_attention as tpa

    cfg = model_config_from_dict(model_config
                                 or {**MAIN_MODEL, "n_layers": 2})
    eng = InferenceEngine(cfg, **(engine_config or MAIN_ENGINE))
    ragged = M.ragged_paged_attention
    seen = {"calls": 0, "worst": 0.0}

    def ragged_and_decode(q, k_pages, v_pages, page_table, q_start, q_len,
                          kv_len, **kw):
        o = ragged(q, k_pages, v_pages, page_table, q_start, q_len, kv_len,
                   **kw)
        if kw.get("decode_rows") == page_table.shape[0] == q.shape[0]:
            d = tpa.paged_attention(q, k_pages, v_pages, page_table, kv_len)
            seen["worst"] = max(seen["worst"], decode_ratios(d, o).max()
                                .item())
            seen["calls"] += 1
        return o

    V = cfg.vocab_size
    prefix = _prompt(1, 256, V)
    for name in tpa.launch_counts:
        tpa.launch_counts[name] = 0
    M.ragged_paged_attention = ragged_and_decode
    try:
        for seed, n in ((9, 40), (10, 20)):
            rid = eng.add_request(prefix + _prompt(seed, n, V), 24)
            done = {}
            for _ in range(100):
                done.update(eng.step())
                if rid in done:
                    break
            assert len(done.get(rid, ())) == 24, done
    finally:
        M.ragged_paged_attention = ragged
    launches = dict(tpa.launch_counts)
    stats = dict(eng.stats)
    steps = cfg.n_layers * eng.decode_chunk * stats["decode_dispatches"]
    del eng
    log(f"paged_attention on the engine's decode steps ({cfg.n_layers} "
        f"layers, dim {cfg.dim}, {cfg.dtype}): {seen['calls']} calls beside "
        f"the ragged kernel, worst {seen['worst']:.3f} x the limit; "
        f"launches {launches}; stats {json.dumps(stats)}")
    assert stats["cached_tokens"] >= 256, stats     # the prefix's pages
    assert seen["worst"] <= 1, f"decode vs ragged at {seen['worst']} x"
    assert seen["calls"] == steps > 0, (seen, steps)
    assert launches["paged_attention"] == steps, (launches, steps)
    assert launches["paged_attention_reference_cuda"] == 0, launches
    assert launches["ragged_paged_attention_reference_cuda"] == 0, launches
    return launches["paged_attention"]


# flash kernel: (products, input rows, output rows) of one call
FLASH_WORK = {
    "flash_attention_fwd": (2, ("q", "k", "k"), ("q",)),        # q k v -> o
    "flash_attention_dq": (3, ("q", "k", "k", "q"), ("q",)),    # +do -> dq
    "flash_attention_dkv": (4, ("q", "k", "k", "q"), ("k", "k")),  # -> dk dv
}


def flash_flops(kernel, BH, Lq, Lk, D, causal):
    """The FLOP one flash kernel call needs: the (query, key) pairs the
    mask lets through times 2·D per product (fwd 2 products: q·kᵀ, p·v;
    dq 3: q·kᵀ, do·vᵀ, ds·k; dkv 4: q·kᵀ, do·vᵀ, pᵀ·do, dsᵀ·q)."""
    pairs = (sum(min(i + 1, Lk) for i in range(Lq)) if causal
             else Lq * Lk) * BH
    return FLASH_WORK[kernel][0] * 2 * D * pairs


def flash_bound_ms(kernel, BH, Lq, Lk, D, causal, itemsize):
    """Least time for one flash kernel call: its FLOP (``flash_flops``)
    at the bf16 tensor-core peak, or each input read and each output
    written once at the HBM rate. Returns (ms, "bytes" | "operations")."""
    _, rows_in, rows_out = FLASH_WORK[kernel]
    rows = sum(Lq if r == "q" else Lk for r in rows_in + rows_out)
    nbytes = BH * D * itemsize * rows
    nbytes += 4 * BH * Lq * (1 if kernel == "flash_attention_fwd" else 2)
    t_ops = flash_flops(kernel, BH, Lq, Lk, D, causal) / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -------------------------------------------------- phase 4: main path


MAIN_MODEL = {"preset": "llama3_8b", "param_dtype": "bfloat16"}
MAIN_ENGINE = {"page_size": 16, "total_pages": 512, "max_batch": 8,
               "max_seq_len": 2048, "decode_chunk": 8, "seed": 0,
               "device": "cuda"}
# the JAX package's serving benchmark (bench_llm.py:29-33): dim 1024, 16
# query / 8 kv heads (head dim 64), pages of 32, bf16; 2 of its 8 layers
BENCH_MODEL = {"preset": "tiny", "vocab_size": 32000, "dim": 1024,
               "n_layers": 2, "n_heads": 16, "n_kv_heads": 8,
               "ffn_dim": 2816, "rope_theta": 500000.0,
               "param_dtype": "bfloat16"}
BENCH_ENGINE = {"page_size": 32, "total_pages": 1024, "max_batch": 8,
                "max_seq_len": 512, "decode_chunk": 32, "prefill_chunk": 128,
                "seed": 0, "device": "cuda"}


def _prompt(seed, n, vocab):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=g).tolist()


def agrees(record_s, timer_s):
    """bench_llm.py's rule for a flight-recorder time against an external
    timer: |record - timer| <= max(5 ms, 15% of the timer)."""
    return abs(record_s - timer_s) <= max(0.005, 0.15 * timer_s)


#: how far a caller's timer may run past the record's first-token and
#: finish times: the record starts after the timer and stops where the
#: tokens reach the host, before the caller's thread takes them. The lag
#: is the caller's: its submission before the record starts, and its
#: wake-up and wait for the GIL after the engine hands it the tokens
#: (``chip_compare.py lag`` measures both; the H100's host wakes a
#: blocked thread in 0.08 ms at the median and up to 4.9 ms). A
#: stamp taken at the dispatch's launch would read short by the whole
#: dispatch.
READBACK_LAG_S = 0.010


@contextlib.contextmanager
def quiet_timers():
    """Run timed callers as ``timeit`` runs its statement: after a full
    collection and with the cyclic collector off, then on again. A
    collection, run by whichever thread allocates, stops every thread:
    in phase 4's process on the H100's host, up to 4 ms for the young
    generations and 170-415 ms for a full one, once or twice a phase."""
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _stamp_launches(fns, stamps):
    """Append the host clock to ``stamps`` as each step dispatch of the
    engine's step functions ``fns`` is launched."""
    for name in ("ragged_step", "decode_loop"):
        def stamped(*args, _inner=getattr(fns, name), **kwargs):
            stamps.append(time.monotonic())
            return _inner(*args, **kwargs)
        setattr(fns, name, stamped)


def main_requests(vocab, chunk):
    """Phase 4's requests: the first wave, sent at once, as (kind,
    prompt, max_tokens) — one prompt prefilled in chunks, one that
    publishes a 256-token prefix — and the prefix-hit request sent alone
    after it."""
    prefix = _prompt(1, 256, vocab)
    reqs = [("stream", _prompt(2, chunk + 188, vocab), 24),     # chunked
            ("call", prefix + _prompt(3, 40, vocab), 16),        # publishes
            ("call", _prompt(4, 20, vocab), 32),
            ("stream", _prompt(5, 9, vocab), 32)]
    hit_req = {"prompt_ids": prefix + _prompt(6, 30, vocab),
               "max_tokens": 16}
    return reqs, hit_req


def admit_together(engine, n, timeout=60.0):
    """Hold the engine's next step until ``n`` requests wait, so that a
    wave sent from ``n`` threads is admitted at one step in whichever
    process it runs, in one order (the longest prompt first, the order
    ``main_requests`` lists them in), whatever order its requests arrived
    in (through Serve's router they race): the engine's schedule, slots
    and row layout are then the same everywhere, and with the same
    weights, kernels and card, so is every token. The hold lifts itself
    at that step."""
    step = engine.step

    def held(*args, **kwargs):
        deadline = time.monotonic() + timeout
        while len(engine.waiting) < n and time.monotonic() < deadline:
            time.sleep(0.0005)
        with engine._lock:
            engine.waiting.sort(key=lambda seq: -len(seq.prompt))
        del engine.step         # the class's method again, and no cycle
        return step(*args, **kwargs)

    engine.step = held


def phase_main_path(model_config=None, engine_config=None,
                    launch_stamp_fails=True):
    """LLMServer end to end; returns the engine's stats, the launches,
    the launches expected, the step programs dispatched in this process
    before and after the phase, and the token streams with each request's
    end-to-end wall time ({"wave": [...], "hit": [...], "e2e_s": {i:
    s}}, the hit request at index len(wave)). The recorder's first-token and
    finish times must trail the caller's timers by 0 to READBACK_LAG_S;
    with ``launch_stamp_fails`` the same times read at each dispatch's
    launch must trail them by more (where a dispatch outlasts the lag,
    so the check tells the two stamps apart)."""
    from ray_tpu_torch.llm.serve_llm import LLMServer
    from ray_tpu_torch.ops import paged_attention as tpa
    from ray_tpu_torch.util import log_plane, metrics, trace_context

    t0 = time.monotonic()
    srv = LLMServer(model_config or MAIN_MODEL, engine_config or MAIN_ENGINE)
    eng = srv.engine
    cfg = eng.cfg
    programs_before = eng.compiled_step_programs()
    assert eng.request_log is not None, "the recorder is on by default"
    launch_ts = []
    _stamp_launches(eng._fns, launch_ts)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    kv_bytes = sum(t.numel() * t.element_size() for t in eng.kv.values())
    w_bytes = sum(t.numel() * t.element_size()
                  for t in [eng.params["embed"], eng.params["final_norm"],
                            *eng.params["layers"].values()])
    log(f"main path: {cfg.n_layers} layers dim {cfg.dim} vocab "
        f"{cfg.vocab_size} {cfg.dtype}, weights {w_bytes} bytes, KV pool "
        f"{kv_bytes} bytes, set-up {time.monotonic() - t0:.1f} s")
    V = cfg.vocab_size
    reqs, hit_req = main_requests(V, eng.prefill_chunk)
    results = [None] * len(reqs)
    # request -> (rid, external TTFT, TPOT and end-to-end seconds; the
    # first two only where a stream shows when its tokens arrive)
    timers = {}
    trace_id = trace_context.new_trace_id()
    traced = 1                  # the request sent under an ambient trace
    # the callers wait here, started, and are released together: a
    # caller's timer then starts after the thread starts of the others
    go = threading.Event()

    def run(i, kind, prompt, max_tokens):
        ctx = trace_context.activate(trace_id, trace_context.new_span_id()) \
            if i == traced else None
        try:
            assert go.wait(60), "the wave was not released"
            t_sub = time.monotonic()
            if kind == "call":
                out = srv({"prompt_ids": prompt, "max_tokens": max_tokens})
                results[i] = out["token_ids"]
                timers[i] = (out["request_id"], None, None,
                             time.monotonic() - t_sub)
                return
            toks, stamps = [], []
            for item in srv.stream({"prompt_ids": prompt,
                                    "max_tokens": max_tokens}):
                if item.get("done"):
                    assert item["token_ids"] == toks
                    break
                toks += item["token_ids"]
                stamps.append(time.monotonic())
            timers[i] = (item["request_id"], stamps[0] - t_sub,
                         (stamps[-1] - stamps[0]) / (len(toks) - 1),
                         time.monotonic() - t_sub)
            results[i] = toks
        finally:
            if ctx is not None:
                trace_context.deactivate(ctx)

    for name in tpa.launch_counts:
        tpa.launch_counts[name] = 0
    try:
        with quiet_timers():
            t_wave = time.monotonic()
            admit_together(eng, len(reqs))
            threads = [threading.Thread(target=run, args=(i, *r))
                       for i, r in enumerate(reqs)]
            for t in threads:
                t.start()
            go.set()
            for t in threads:
                t.join(600)
                assert not t.is_alive(), "request thread hung"
            wave_s = time.monotonic() - t_wave
            # after the first wave published the shared prefix: a hit,
            # alone (one ragged step, two decode dispatches), timed; then
            # the same request again under the profiler for the device's
            # busy time
            t_hit = time.monotonic()
            hit_out = srv(hit_req)
            hit = hit_out["token_ids"]
            hit_ms = (time.monotonic() - t_hit) * 1e3
        timers[len(reqs)] = (hit_out["request_id"], None, None,
                             hit_ms / 1e3)
        _, busy = profile_device(lambda: srv(hit_req), eng.device, hit_ms,
                                 focus=("ragged",))
        srv.check_health()
    finally:
        srv.shutdown()
    launches = dict(tpa.launch_counts)
    stats = srv.stats()
    programs = eng.compiled_step_programs()
    eng._update_metrics(force=True)
    gauges = {name: m["values"][()] for name, m in metrics.snapshot().items()
              if m["type"] == "gauge" and name.startswith("llm_")}
    records = {d["rid"]: d for d in srv.request_records()}
    logs = log_plane.get_global().export()["records"]
    for (kind, prompt, max_tokens), toks in zip(reqs, results):
        assert toks is not None and len(toks) == max_tokens, (kind, toks)
        assert all(0 <= t < V for t in toks)
    assert len(hit) == 16
    assert stats["prefix_cache"]["hit_tokens"] >= 256, stats
    assert stats["ragged_dispatches"] >= 3, stats     # chunked prefill
    expected = cfg.n_layers * (stats["ragged_dispatches"]
                               + eng.decode_chunk
                               * stats["decode_dispatches"])
    n_tok = sum(len(t) for t in results)
    log(f"main path: {len(reqs) + 2} requests, {n_tok} tokens in the "
        f"first wave in {wave_s:.2f} s ({n_tok / wave_s:.1f} tokens/s), "
        f"stats {json.dumps(stats)}")
    for i, (_, t_first, tpot, _) in sorted(timers.items()):
        if t_first is not None:
            log(f"main path: stream request {i} ({len(reqs[i][1])} prompt "
                f"tokens): TTFT {t_first * 1e3:.1f} ms, decode "
                f"{1 / tpot:.1f} tokens/s over {len(results[i])} tokens")
    log(f"main path: prefix-hit request alone: {hit_ms:.1f} ms; the same "
        f"request under the profiler: {busy}")
    log(f"main path: launches {launches}, expected ragged_paged_attention "
        f"{expected}")
    # the flight recorder against the external timers (bench_llm.py's
    # agreement rule): TTFT and TPOT where a stream shows when its tokens
    # arrive, end to end for every request; TTFT and e2e also against the
    # readback lag, beside what a stamp at the dispatch's launch would read
    for i, (rid, t_first, tpot, e2e) in sorted(timers.items()):
        rec = records[rid]
        t0 = eng.request_log.get(rid).t0

        def at_launch(off):
            return max(s for s in launch_ts if s <= t0 + off) - t0

        pairs = [("TTFT", rec["ttft"], t_first), ("TPOT", rec["tpot"], tpot),
                 ("e2e", rec["e2e"], e2e)]
        n_prompt = len(reqs[i][1]) if i < len(reqs) else len(
            hit_req["prompt_ids"])
        log(f"main path: request {i} ({n_prompt} prompt tokens, "
            f"{rec['n_generated']} generated, cached {rec['cached_tokens']}, "
            f"{len(rec['chunks'])} chunks): " + ", ".join(
                f"{name} record {r * 1e3:.2f} ms"
                + ("" if t is None else f" vs timer {t * 1e3:.2f} ms")
                + ("" if t is None or name == "TPOT" else
                   f" (stamped at launch {at_launch(r) * 1e3:.2f} ms)")
                for name, r, t in pairs if r is not None))
        for name, r, t in pairs:
            if t is None:
                continue
            assert agrees(r, t), \
                f"request {i}: {name} record {r} s vs timer {t} s"
            if name == "TPOT":
                continue
            assert 0 <= t - r <= READBACK_LAG_S, \
                f"request {i}: {name} timer {t} s - record {r} s"
            if launch_stamp_fails:
                assert t - at_launch(r) > READBACK_LAG_S, \
                    f"request {i}: {name} stamped at launch " \
                    f"{at_launch(r)} s vs timer {t} s: the lag check " \
                    f"cannot tell it from the readback"
    log(f"main path: gauges after _update_metrics(force=True): "
        f"{json.dumps(gauges)}")
    log(f"main path: step programs dispatched in this process: "
        f"{programs_before} before the phase, {programs} after it")
    assert programs - programs_before <= 3, (programs_before, programs)
    assert gauges["llm_compiled_step_programs"] == programs, gauges
    # the traced request's log records carry its request id and the
    # ambient trace id, as its flight-recorder record does
    rid = timers[traced][0]
    mine = [r for r in logs if r["request_id"] == rid]
    log(f"main path: log records of request {traced} ({rid}): "
        f"{[(r['level'], r['msg'], r['trace_id']) for r in mine]}")
    assert len(mine) == 2 and all(r["trace_id"] == trace_id for r in mine)
    assert records[rid]["trace_id"] == trace_id
    for j, (other, _, _, _) in timers.items():
        if j != traced:
            assert [r["trace_id"] for r in logs
                    if r["request_id"] == other] == ["", ""], j
    streams = {"wave": results, "hit": hit,
               "e2e_s": {i: t[3] for i, t in timers.items()},
               "wave_s": wave_s, "hit_ms": hit_ms}
    return stats, launches, expected, (programs_before, programs), streams


def profile_device(fn, device, unprofiled_ms, focus=()):
    """Run fn() under torch.profiler; returns (result, summary): the
    device's busy time (kernel time, one stream), its share of
    ``unprofiled_ms`` (the same work timed without the profiler, whose
    host cost would otherwise inflate the idle share), the kernels
    taking most of it, and for each name in ``focus`` the kernels whose
    name holds it: their time, launches and share of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    top = "; ".join(f"{k[:60]} x{n} {ms:.4f} ms" for ms, n, k in rows[:6])
    parts = []
    for name in focus:
        ms = sum(r[0] for r in rows if name in r[2])
        n = sum(r[1] for r in rows if name in r[2])
        share = ms / busy_ms if busy_ms else 0.0   # no device time on a CPU
        parts.append(f"{name} x{n} {ms:.4f} ms = {share:.1%}")
    picked = f"; of the busy time: {', '.join(parts)}" if parts else ""
    return out, (f"device busy {busy_ms:.4f} ms = "
                 f"{busy_ms / unprofiled_ms:.1%} of the unprofiled wall "
                 f"time, top: {top}{picked}")


# --------------------------------------------- phase 5: engine vs oracle


def phase_oracle(device, cfg=None, page_size=16):
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.models.llama import (LlamaConfig, forward,
                                            init_params)

    cfg = cfg or LlamaConfig.llama3_8b(n_layers=2, dtype=torch.float32)
    params = init_params(cfg, seed=1, device=device)
    eng = InferenceEngine(cfg, params, page_size=page_size, total_pages=64,
                          max_batch=4, max_seq_len=256, prefill_chunk=16,
                          decode_chunk=4, device=device)
    prompts = [_prompt(7, 37, cfg.vocab_size), _prompt(8, 9, cfg.vocab_size)]
    rids = [eng.add_request(p, 8) for p in prompts]
    done = {}
    for _ in range(100):
        done.update(eng.step())
        if all(r in done for r in rids):
            break
    compared = 0
    for rid, prompt in zip(rids, prompts):
        toks = list(prompt)
        for got in done[rid]:
            with torch.no_grad():
                logits = forward(params, torch.tensor([toks], device=device),
                                 cfg)[0, -1]
            top2 = logits.topk(2)
            want = int(top2.indices[0])
            margin = float(top2.values[0] - top2.values[1])
            if got != want:
                assert margin < FP32_LOGIT_NOISE, \
                    f"engine {got} vs oracle {want} at margin {margin}"
                break
            compared += 1
            toks.append(want)
    assert compared >= 8, f"only {compared} tokens compared"
    log(f"engine vs full forward (dim {cfg.dim}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, vocab {cfg.vocab_size}, {cfg.n_layers} layers, "
        f"page {page_size}, fp32): {compared} of 16 greedy tokens "
        f"compared equal, stats {json.dumps(eng.stats)}")


# ------------------------------------------ phase 6: the flash kernels

FLASH_SHAPE = (8, 24, 2048, 128)    # B, H, L, D of the training path
# the planted faults must fail on every query tile of this many rows: the
# dk/dv kernel's bf16 q tiles (half of the forward's)
FLASH_TILE = 64
# the bf16 kernels redesigned for Hopper, whose ptxas report phase 2
# prints: (library, kernel)
SM90_KERNELS = (("flash_attention_fwd", "flash_fwd_sm90_kernel"),
                ("flash_attention_bwd", "flash_dq_sm90_kernel"),
                ("flash_attention_bwd", "flash_dkv_sm90_kernel"),
                ("ragged_paged_attention", "ragged_sm90_kernel"),
                ("paged_attention", "paged_decode_sm90_kernel"),
                ("paged_attention", "paged_decode_merge_sm90_kernel"))


def causal_off_by_one(q, k, v, scale):
    """A planted fault: the plain forward where query i sees keys 0..i+1,
    one more than the causal mask allows. Query i is moved to position
    i + 1 of a sequence padded by one tile (the key at position L, seen
    only by the last query, is a copy of key 0)."""
    from ray_tpu_torch.ops import flash_attention as tfa
    L = q.shape[1]
    qs = torch.cat([q[:, :1], q, q[:, :FLASH_TILE - 1]], 1)
    ks = torch.cat([k, k[:, :FLASH_TILE]], 1)
    vs = torch.cat([v, v[:, :FLASH_TILE]], 1)
    o, lse = tfa._fwd_reference(qs, ks, vs, True, scale, FLASH_TILE,
                                FLASH_TILE)
    return o[:, 1:L + 1], lse[:, 1:L + 1]


def tiles_caught(fault, ref):
    """Worst ratio to the limit within each query tile (over every bh
    and row of the tile; the last tile may be shorter):
    [ceil(L / FLASH_TILE)]."""
    r = flash_ratios(fault, ref).amax(0)
    return torch.stack([t.amax() for t in r.split(FLASH_TILE)])


def phase_flash(device):
    import torch.nn.functional as F
    from ray_tpu_torch.ops import flash_attention as tfa

    B, H, L, D = FLASH_SHAPE
    BH, scale = B * H, D ** -0.5
    g = torch.Generator(device=device).manual_seed(2)
    q, k, v, do = (torch.randn(BH, L, D, generator=g, device=device)
                   .bfloat16() for _ in range(4))
    dlse = torch.randn(BH, L, generator=g, device=device)
    names = ("flash_attention_fwd", "flash_attention_dq",
             "flash_attention_dkv")
    variants = tfa.tile_variants(q.dtype, D)
    # per (kernel, its tile): the largest error and the worst ratio
    err, worst = {}, {}
    for case, causal, cot in (("causal", True, None),
                              ("non-causal", False, None),
                              ("causal, lse cotangent", True, dlse)):
        o_ref, lse_ref = tfa._fwd_reference(q, k, v, causal, scale)
        delta = (do.float() * o_ref.float()).sum(-1)
        if cot is not None:
            delta = delta - cot
        grads_ref = tfa._bwd_reference(q, k, v, lse_ref, do, delta, causal,
                                       scale)
        for tiles in variants:
            o, lse = tfa._fwd_call(q, k, v, causal, scale, tiles=tiles)
            grads = tfa._bwd_call(q, k, v, o_ref, lse_ref, do, causal,
                                  scale, dlse=cot, tiles=tiles)
            torch.cuda.synchronize()
            lse_err = (lse - lse_ref).abs().max().item()
            assert lse_err <= LSE_ATOL, \
                f"{case}, {tiles}: lse off by {lse_err}"
            checks = [("flash_attention_fwd", "o", o, o_ref)] + [
                (kern, name, got, want) for kern, name, got, want in zip(
                    names[1:] + names[2:], ("dq", "dk", "dv"), grads,
                    grads_ref)]
            line = []
            for kern, name, got, want in checks:
                tile = tiles[names.index(kern)]
                assert torch.isfinite(got).all(), \
                    f"{case}, {tiles}: {name} not finite"
                ratio = flash_ratios(got, want).max().item()
                assert ratio <= 1, \
                    f"{case}, {tiles}: {name} at {ratio} x the limit"
                at = (kern, tile)
                err[at] = max(err.get(at, 0.0), (got.float() - want.float())
                              .abs().max().item())
                worst[at] = max(worst.get(at, 0.0), ratio)
                line.append(f"{name} {ratio:.3f}")
            log(f"flash kernels vs plain, {case}, tiles fwd {tiles.fwd} dq "
                f"{tiles.dq} dk/dv {tiles.dkv}: worst ratio to the limit "
                f"{', '.join(line)}; lse max diff {lse_err:.2e}")
    # planted faults, each must fail on every query tile
    o_ref, lse_ref = tfa._fwd_reference(q, k, v, True, scale)
    caught = tiles_caught(causal_off_by_one(q, k, v, scale)[0], o_ref)
    assert bool((caught > 1).all()), f"off-by-one not caught: {caught}"
    log(f"planted fault (causal off by one): all {caught.numel()} query "
        f"tiles fail, the weakest at {caught.min().item():.1f} x the limit")
    delta = (do.float() * o_ref.float()).sum(-1)
    right = tfa._bwd_reference(q, k, v, lse_ref, do, delta - dlse, True,
                               scale)[0]
    wrong = tfa._bwd_reference(q, k, v, lse_ref, do, delta, True, scale)[0]
    caught = tiles_caught(wrong, right)
    assert bool((caught > 1).all()), f"missing -dlse not caught: {caught}"
    log(f"planted fault (backward without - dlse): all {caught.numel()} "
        f"query tiles of dq fail, the weakest at "
        f"{caught.min().item():.1f} x the limit")

    # no atomics: every variant repeats bit for bit
    for tiles in variants:
        runs = [(*tfa._fwd_cuda(q, k, v, True, scale, tiles.fwd),
                 *tfa._bwd_cuda(q, k, v, lse_ref, do, delta - dlse, True,
                                scale, tiles)) for _ in range(2)]
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs)), \
            f"{tiles}: not repeatable"
        log(f"flash kernels, tiles fwd {tiles.fwd} dq {tiles.dq} dk/dv "
            f"{tiles.dkv}: two calls give the same bits (o, lse, dq, dk, "
            f"dv)")
        del runs

    # times at the training path's shape, causal, of every variant
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    kern_ms = {}
    for kern in names:
        for tile in dict.fromkeys(t[names.index(kern)] for t in variants):
            kern_ms[kern, tile] = time_ms({
                "flash_attention_fwd": lambda: tfa._fwd_cuda(
                    q, k, v, True, scale, tile),
                "flash_attention_dq": lambda: tfa._launch_dq(
                    q, k, v, do, lse_ref, delta, dq, True, scale, tile),
                "flash_attention_dkv": lambda: tfa._launch_dkv(
                    q, k, v, do, lse_ref, delta, dk, dv, True, scale,
                    tile)}[kern], flush=flush)
    fwd_plain = time_ms(lambda: tfa._fwd_reference(q, k, v, True, scale),
                        iters=3, flush=flush)
    bwd_plain = time_ms(lambda: tfa._bwd_reference(
        q, k, v, lse_ref, do, delta, True, scale), iters=3, flush=flush)
    q4, k4, v4 = (t.view(B, H, L, D).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    lib_err = (lib_out.reshape(BH, L, D).float() - o_ref.float()).abs() \
        .max().item()
    assert lib_err <= LIBRARY_ATOL, f"SDPA yardstick differs {lib_err}"
    do4 = do.view(B, H, L, D)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), flush=flush)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (q4, k4, v4), do4, retain_graph=True), flush=flush)
    plain = {"flash_attention_fwd": fwd_plain, "flash_attention_dq": bwd_plain,
             "flash_attention_dkv": bwd_plain}
    library = {"flash_attention_fwd": lib_fwd, "flash_attention_dq": lib_bwd,
               "flash_attention_dkv": lib_bwd}
    out = {}
    for (kern, tile), ms in kern_ms.items():
        default = tile == variants[0][names.index(kern)]
        bound, by = flash_bound_ms(kern, BH, L, L, D, True, q.element_size())
        tflops = flash_flops(kern, BH, L, L, D, True) / ms / 1e9
        if default:
            out[kern] = dict(max_abs_err=err[kern, tile], ms=ms,
                             plain_ms=plain[kern], library_ms=library[kern],
                             bound_ms=bound, bound_by=by)
        log(f"{kern} tile {tile}{' (default)' if default else ''} B {B} H "
            f"{H} L {L} D {D} bf16 causal: kernel {ms:.4f} ms = "
            f"{tflops:.1f} TFLOP/s, {bound / ms:.1%} of its bound; plain "
            f"{plain[kern]:.4f} ms, sdpa {library[kern]:.4f} ms, bound "
            f"{bound:.4f} ms ({by}); max_abs_err {err[kern, tile]:.3e}, "
            f"worst {worst[kern, tile]:.3f} x the tolerance")
    log("flash plain and sdpa times: the backward's (dq and dk/dv "
        "together) stand for both dq and dkv")
    bwd_ms = out["flash_attention_dq"]["ms"] + out["flash_attention_dkv"]["ms"]
    log(f"flash backward kernels (default tiles), dq + dk/dv: {bwd_ms:.4f} "
        f"ms = {bwd_ms / lib_bwd:.2f} x SDPA's whole backward "
        f"({lib_bwd:.4f} ms)")
    del flush
    return out


# lengths the Pallas kernels take that no kernel tile divides (Lq, Lk):
# L <= 256 at their default blocks, L 1000 at blocks of 8, and Lq 72
# against Lk 200
FLASH_LENGTHS = ((72, 72), (200, 200), (1000, 1000), (72, 200))


def phase_flash_lengths(device):
    """The three flash kernels, every tile variant, at FLASH_LENGTHS (B 2,
    H 24, D 128, bf16, causal and not, with an lse cotangent) against
    their plain versions at the default blocks, where the last q tile and
    key tile run past the end of every sequence; the planted causal fault
    must fail on every query tile (Lq = Lk)."""
    from ray_tpu_torch.ops import flash_attention as tfa

    B, H, D = 2, 24, 128
    BH, scale = B * H, D ** -0.5
    variants = tfa.tile_variants(torch.bfloat16, D)
    worst = 0.0
    for Lq, Lk in FLASH_LENGTHS:
        g = torch.Generator(device=device).manual_seed(Lq + Lk)
        q, do = (torch.randn(BH, Lq, D, generator=g, device=device)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(BH, Lk, D, generator=g, device=device)
                .bfloat16() for _ in range(2))
        dlse = torch.randn(BH, Lq, generator=g, device=device)
        line = []
        for causal in (True, False):
            o_ref, lse_ref = tfa._fwd_reference(q, k, v, causal, scale)
            delta = (do.float() * o_ref.float()).sum(-1) - dlse
            grads_ref = tfa._bwd_reference(q, k, v, lse_ref, do, delta,
                                           causal, scale)
            for i, tiles in enumerate(variants):
                o, lse = tfa._fwd_cuda(q, k, v, causal, scale, tiles.fwd)
                grads = tfa._bwd_cuda(q, k, v, lse_ref, do, delta, causal,
                                      scale, tiles)
                torch.cuda.synchronize()
                lse_err = (lse - lse_ref).abs().max().item()
                assert lse_err <= LSE_ATOL, \
                    f"L {Lq}/{Lk}, {tiles}: lse off by {lse_err}"
                for name, got, want in zip(("o", "dq", "dk", "dv"),
                                           (o, *grads), (o_ref, *grads_ref)):
                    assert got.shape == want.shape and \
                        torch.isfinite(got).all(), \
                        f"L {Lq}/{Lk}, {tiles}: {name}"
                    ratio = flash_ratios(got, want).max().item()
                    assert ratio <= 1, (f"L {Lq}/{Lk} causal {causal}, "
                                        f"{tiles}: {name} at {ratio} x")
                    worst = max(worst, ratio)
                    line.append(f"{'causal' if causal else 'full'} "
                                f"variant {i} {name} {ratio:.3f}")
        fault = ""
        if Lq == Lk:
            o_ref, _ = tfa._fwd_reference(q, k, v, True, scale)
            caught = tiles_caught(causal_off_by_one(q, k, v, scale)[0],
                                  o_ref)
            assert bool((caught > 1).all()), \
                f"L {Lq}: off-by-one not caught: {caught}"
            fault = (f"; planted fault (causal off by one) fails on all "
                     f"{caught.numel()} query tiles, the weakest at "
                     f"{caught.min().item():.1f} x the limit")
        names = ", ".join(f"{i}: {t}" for i, t in enumerate(variants))
        log(f"flash kernels at Lq {Lq} Lk {Lk} (BH {BH}, D {D}, bf16; "
            f"variants {names}): worst ratio to the limit "
            f"{', '.join(line)}{fault}")
    return worst


# ------------------------------- phase 5b: recorder A/B, batch predictor


def bench_prompt(j, vocab, n=128):
    """bench_llm.py's mk_prompt: a distinct prompt per j."""
    return [(7 * i + 3 + 131 * j) % vocab for i in range(n)]


def phase_recorder_ab(model_config=None, engine_config=None):
    """bench_llm.py's recorder A/B: 8 requests x 64 new tokens of decode
    wall time on two fresh engines sharing one set of weights, recorder
    off then on, and the raw cost of one ``note_decode``. One noisy run
    of each, so printed, not asserted."""
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.llm.request_log import RequestRecord
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict

    cfg = model_config_from_dict(model_config or BENCH_MODEL)
    kw = dict(engine_config or BENCH_ENGINE)
    params = InferenceEngine(cfg, **kw).params
    uniq = iter(range(1, 10_000))

    def timed_run(recorder_on):
        e = InferenceEngine(cfg, params, request_log=recorder_on, **kw)
        for _ in range(8):
            e.add_request(bench_prompt(next(uniq), cfg.vocab_size), 64)
        e.step()                       # admit + first prefill rows
        t0 = time.perf_counter()
        while e.has_work():
            e.step()
        return time.perf_counter() - t0

    t_off = timed_run(False)
    t_on = timed_run(True)
    probe = RequestRecord("probe", 1, 1 << 20)
    t0 = time.perf_counter()
    for i in range(100_000):
        probe.note_decode(t0 + i * 1e-6, 1)
    event_ns = (time.perf_counter() - t0) / 100_000 * 1e9
    log(f"recorder A/B (bench widths, {cfg.n_layers} layers, 8 requests x "
        f"64 tokens): decode wall time off {t_off * 1e3:.1f} ms, on "
        f"{t_on * 1e3:.1f} ms, overhead {t_on / t_off - 1.0:+.2%} (one run "
        f"each); one note_decode {event_ns:.0f} ns on the host")


def phase_batch_predictor(model_config=None, engine_config=None):
    """``LLMBatchPredictor`` over 8 rows at the bench widths against the
    engine's ``generate`` on the same prompts, one at a time, on the same
    weights: tokens and finish reasons equal. fp32: a row's logits then
    differ between a batch of 8 and a request alone by summation order
    only (the ragged kernel splits a decode row by the batch's hints),
    far below the top-2 margins of greedy decoding."""
    from ray_tpu_torch.llm.batch import LLMBatchPredictor
    from ray_tpu_torch.llm.engine import InferenceEngine

    model_config = model_config or {**BENCH_MODEL, "dtype": "float32"}
    engine_config = engine_config or BENCH_ENGINE
    pred = LLMBatchPredictor(model_config, engine_config, max_new_tokens=32)
    cfg = pred.engine.cfg
    rows = [{"prompt": _prompt(20 + j, n, cfg.vocab_size), "id": j}
            for j, n in enumerate((5, 17, 40, 64, 100, 129, 200, 300))]
    t0 = time.monotonic()
    out = pred(rows)
    batch_s = time.monotonic() - t0
    alone = InferenceEngine(cfg, pred.engine.params, **engine_config)
    for row, got in zip(rows, out):
        want = alone.generate(row["prompt"], 32)
        reason = alone.request_log.snapshot()[-1]["finish_reason"]
        assert got["id"] == row["id"] and got["generated"] == want, \
            (row["id"], got["generated"], want)
        assert got["finish_reason"] == reason, (got["finish_reason"], reason)
        assert got["generated_text"] == pred.tokenizer.decode(want)
    log(f"LLMBatchPredictor (bench widths, {cfg.n_layers} layers, "
        f"{cfg.dtype}): 8 rows of 5-300 prompt tokens x 32 new in "
        f"{batch_s:.2f} s, {pred.engine.stats['ragged_dispatches']} ragged "
        f"steps; every row's tokens and finish reason "
        f"({sorted({r['finish_reason'] for r in out})}) equal generate's")


# ------------------------------------------- phase 7: training main path

TRAIN_CONFIG = dict(vocab_size=32000, dim=3072, n_layers=8, n_heads=24,
                    n_kv_heads=12, ffn_dim=12288, attention="flash",
                    remat_policy="selective")
TRAIN_BATCH = (8, 2048)             # B, L
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
#: phase 7's losses, step time, tokens/s, MFU and peak memory by
#: optimizer, for phase 16b's comparison
TRAIN_RUNS = {}


def make_optimizer(name):
    """bench.py trains with optax.adafactor(1e-3); "adamw" is
    optax.adamw(1e-3)'s defaults, which this phase trained with before
    Adafactor was ported."""
    from ray_tpu_torch.train import Adafactor
    return {"adafactor": functools.partial(Adafactor, lr=1e-3),
            "adamw": functools.partial(torch.optim.AdamW, lr=1e-3,
                                       weight_decay=1e-4)}[name]


def phase_train(device, config=None, batch=TRAIN_BATCH,
                optimizer="adafactor", steps=TRAIN_STEPS, profile=True,
                tag=None):
    """make_train_step at the bench widths; returns the flash launches
    counted over the warm-up and timed steps, the steps run, and the
    layers (``tfa.variant_launches`` holds them by tile variant). With
    ``profile``, then the step profiler (its gauges printed) and one step
    under torch.profiler. The run is kept in ``TRAIN_RUNS`` under ``tag``
    (default: the optimizer's name)."""
    from ray_tpu_torch.models.llama import (LlamaConfig, flops_per_token,
                                            init_params, loss_fn,
                                            num_params)
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.train import make_train_step, profile_train_step
    from ray_tpu_torch.util import metrics as metrics_mod

    cfg = LlamaConfig(**(config or TRAIN_CONFIG))
    B, L = batch
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, L), generator=g,
                           device=device)
    loss = functools.partial(loss_fn, cfg=cfg)
    opt_name, optimizer = optimizer, make_optimizer(optimizer)
    init_fn, step_fn = make_train_step(loss, optimizer)
    opt = init_fn(params)
    cuda = device.type == "cuda"
    log(f"training: {num_params(cfg)} parameters, {cfg.n_layers} layers "
        f"dim {cfg.dim}, attention {cfg.attention}, remat "
        f"{cfg.remat_policy}, B {B} L {L}, {opt_name} "
        f"{optimizer.keywords}, set-up {time.monotonic() - t0:.1f} s")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for name in tfa.launch_counts:
        tfa.launch_counts[name] = 0
    tfa.variant_launches.clear()
    metrics, times = [], []
    for i in range(TRAIN_WARMUP + steps):
        t_step = time.monotonic()
        params, opt, m = step_fn(params, opt, tokens)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))  # syncs
        times.append(time.monotonic() - t_step)
    launches = dict(tfa.launch_counts)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = [x for x, _ in metrics]
    assert all(math.isfinite(x) and math.isfinite(n)
               for x, n in metrics), metrics
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    step_s = sum(times[TRAIN_WARMUP:]) / steps
    tok_s = B * L / step_s
    mfu = tok_s * flops_per_token(cfg, L) / BF16_FLOPS
    state_bytes = sum(t.numel() * t.element_size()
                      for s in opt.state.values() for t in s.values()
                      if isinstance(t, torch.Tensor)
                      and t.device.type == device.type)
    log(f"training ({opt_name}): losses {[round(x, 4) for x in losses]}, "
        f"grad norms {[round(n, 4) for _, n in metrics]}")
    log(f"training: step {step_s * 1e3:.1f} ms (mean of {steps} after "
        f"{TRAIN_WARMUP} warm-up, {opt_name}), {tok_s:.0f} tokens/s, MFU "
        f"{mfu:.1%} of 989 TFLOP/s (H100 SXM dense bf16 peak), peak memory "
        f"{peak} bytes (torch.cuda.max_memory_allocated), optimizer state "
        f"{state_bytes} bytes on the card")
    log(f"training: launches {launches} over {TRAIN_WARMUP + steps} steps; "
        f"by tile variant "
        f"{ {f'{e} {t}': n for (e, t), n in tfa.variant_launches.items()} }")
    TRAIN_RUNS[tag or opt_name] = {"losses": losses, "step_s": step_s,
                                   "tok_s": tok_s, "mfu": mfu, "peak": peak}
    if profile:
        bd = profile_train_step(loss, optimizer, params, opt, tokens,
                                steps=3, warmup=1, emit=True)
        log(f"training: profile_train_step step "
            f"{bd.step_time_s * 1e3:.1f} ms, first-step excess "
            f"{bd.compile_time_s * 1e3:.1f} ms, phases ms "
            f"{json.dumps({k: round(x, 2) for k, x in bd.phase_ms().items()})}")
        snap = metrics_mod.snapshot()
        gauges = {f"{name}{dict(zip(snap[name]['tag_keys'], key))}": v
                  for name in ("train_step_time_s", "train_phase_time_s")
                  for key, v in snap[name]["values"].items()}
        log(f"training: gauges set by profile_train_step(emit=True): "
            f"{json.dumps(gauges)}")
        assert gauges["train_step_time_s{}"] == bd.step_time_s, gauges
        _, busy = profile_device(lambda: step_fn(params, opt, tokens),
                                 device, step_s * 1e3,
                                 focus=("flash_fwd", "flash_dq",
                                        "flash_dkv"))
        log(f"training: one step under the profiler: {busy}")
    return launches, TRAIN_WARMUP + steps, cfg.n_layers


def expected_flash_launches(n_layers, steps):
    """Per layer per step: the forward twice (with the remat recompute),
    dq and dk/dv once; the plain versions never on CUDA tensors."""
    return {"flash_attention_fwd": 2 * n_layers * steps,
            "flash_attention_dq": n_layers * steps,
            "flash_attention_dkv": n_layers * steps,
            "flash_attention_fwd_reference_cuda": 0,
            "flash_attention_bwd_reference_cuda": 0}


# ------------------------------- phase 7b: the sweep, then tuned steps

#: phase 7's step with other flash tiles against the untuned run: the
#: losses of each step within this of the untuned run's. The variants
#: round p and ds to bf16 at other points than the defaults (a bf16 step
#: in some attention outputs and gradients: within FLASH_RTOL of each
#: row), and 7 Adafactor steps carry that into the weights; the loss
#: moves by 0.07-0.9 a step over those steps (10.87 -> 7.24, PERF.md), so
#: 1e-3 of it stays far below one step's change. Tiles equal to the
#: defaults launch the same kernels and must repeat the untuned run as
#: phase 16b's trainer does (TRAINER_LOSS_RTOL).
TUNED_LOSS_RTOL = 1e-3


def phase_autotune(device, shape=FLASH_SHAPE):
    """The sweep bench.py runs eagerly before its steps (bench.py:292-295):
    ``autotune_blocks`` at phase 7's attention shape with ``measure``
    None, which times on the card, each kernel's built variants one
    kernel at a time. Logs every candidate's time and the pick; returns
    the cached FlashTiles."""
    from ray_tpu_torch.ops import flash_attention as tfa
    _, _, L, D = shape
    tfa.clear_block_cache()
    tfa.last_sweep.clear()
    t0 = time.monotonic()
    tiles = tfa.autotune_blocks(L, L, D, torch.bfloat16, device=device)
    sweep_s = time.monotonic() - t0
    assert tiles is not None and tfa.get_tuned_blocks(
        L, L, D, torch.bfloat16, device) == tiles, tiles
    cands = tfa.kernel_candidates(D, torch.bfloat16,
                                  tfa._platform(device))
    if device.type == "cuda":
        assert {k: list(ms) for k, ms in tfa.last_sweep.items()} == cands, \
            (tfa.last_sweep, cands)
    for kern, ms in tfa.last_sweep.items():
        log(f"autotune_blocks({L}, {L}, {D}, bf16), {kern}: "
            + ", ".join(f"tile {t} {x:.4f} ms" for t, x in ms.items())
            + f" (median of 3 launches, {tfa.SWEEP_HEADS} heads); pick "
            f"{getattr(tiles, kern)}")
    log(f"autotune_blocks: picked fwd {tiles.fwd}, dq {tiles.dq}, dk/dv "
        f"{tiles.dkv} in {sweep_s:.2f} s; defaults "
        f"{tuple(tfa.default_tiles(torch.bfloat16, D))}")
    return tiles


def phase_train_tiles(device, tiles, tag, config=None, batch=TRAIN_BATCH):
    """Phase 7's Adafactor run (2 warm-up and 5 timed steps, no profile)
    with ``tiles`` the cached entry of its attention shape, which Llama's
    flash path reads (blk None): its losses against the untuned run's
    (``TRAIN_RUNS["adafactor"]``) within TUNED_LOSS_RTOL, to the bit's
    TRAINER_LOSS_RTOL where the tiles are the defaults; every flash launch
    at ``tiles``' variant, as many as the path's count. Returns the
    launches."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.ops import flash_attention as tfa
    cfg = LlamaConfig(**(config or TRAIN_CONFIG))
    L = batch[1]
    tfa._BLOCK_CACHE[tfa._block_cache_key(L, L, cfg.head_dim, cfg.dtype,
                                          device)] = tiles
    launches, steps, n_layers = phase_train(device, config, batch,
                                            profile=False, tag=tag)
    expected = expected_flash_launches(n_layers, steps)
    if device.type != "cuda":   # the plain versions: no launch
        expected = dict.fromkeys(expected, 0)
    assert launches == expected, (launches, expected)
    if device.type == "cuda":
        assert tfa.variant_launches == {
            (tfa._ENTRY[kern], getattr(tiles, kern)):
            expected[tfa._ENTRY[kern]] for kern in tfa.FLASH_KERNELS}, \
            tfa.variant_launches
    got, want = TRAIN_RUNS[tag]["losses"], TRAIN_RUNS["adafactor"]["losses"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    default = tiles == tfa.default_tiles(cfg.dtype, cfg.head_dim)
    limit = TRAINER_LOSS_RTOL if default else TUNED_LOSS_RTOL
    log(f"training ({tag}: fwd {tiles.fwd}, dq {tiles.dq}, dk/dv "
        f"{tiles.dkv}): losses at most {gap:.3e} of the untuned run's "
        f"(limit {limit:g}); step {TRAIN_RUNS[tag]['step_s'] * 1e3:.1f} ms "
        f"against {TRAIN_RUNS['adafactor']['step_s'] * 1e3:.1f}")
    assert gap <= limit, (tag, got, want)
    return launches


# --------------------------------------------- phase 8: training oracle


def phase_train_oracle(device, config=None, batch=(1, 256)):
    """Loss and every gradient, fp32, flash kernels vs full attention."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.train import param_leaves

    cfg = LlamaConfig(**{**(config or TRAIN_CONFIG), "n_layers": 2,
                         "dtype": torch.float32})
    params = init_params(cfg, seed=3, device=device)
    g = torch.Generator(device=device).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, batch, generator=g,
                           device=device)
    results = {}
    before = dict(tfa.launch_counts)
    for attention in ("flash", "full"):
        p = {k: v.clone().requires_grad_() if isinstance(v, torch.Tensor)
             else {n: t.clone().requires_grad_() for n, t in v.items()}
             for k, v in params.items()}
        loss = loss_fn(p, tokens, dataclasses.replace(cfg,
                                                      attention=attention))
        loss.backward()
        results[attention] = (loss.item(), param_leaves(p))
    for name in ("flash_attention_fwd_reference_cuda",
                 "flash_attention_bwd_reference_cuda"):
        assert tfa.launch_counts[name] == before[name], name
    (lf, pf), (lr, pr) = results["flash"], results["full"]
    assert abs(lf - lr) <= TRAIN_ORACLE_LOSS_RTOL * abs(lr), (lf, lr)
    worst = 0.0
    for a, b in zip(pf, pr):
        rel = ((a.grad - b.grad).abs().max() / b.grad.abs().max()).item()
        assert rel <= TRAIN_ORACLE_RTOL, f"grad of {tuple(a.shape)}: {rel}"
        worst = max(worst, rel)
    log(f"training oracle (dim {cfg.dim}, vocab {cfg.vocab_size}, "
        f"{cfg.n_layers} layers, fp32, B {batch[0]} L {batch[1]}): loss "
        f"flash {lf:.6f} vs full {lr:.6f}; {len(pf)} gradients, worst "
        f"{worst:.2e} of the leaf's largest value")


# ------------------------------------------- phase 9: optimizer on the card

# leaves whose second-largest dim is at least 128 factor their second
# moments (stacked, transposed, square), the others keep a full one; one
# parameter's RMS sits under the 1e-3 floor of its scale
ADAFACTOR_TREE = {"stacked": ((4, 256, 512), 0.05),
                  "transposed": ((512, 128), 0.05),
                  "square": ((2, 256, 256), 0.05),
                  "below_128": ((127, 300), 0.05),
                  "norms": ((4, 256), 1.0),
                  "tiny_scale": ((128, 160), 1e-5)}
# fp32 on both devices, the same gradients: the means of g^2 and the RMS
# of the update and of the parameter differ in summation order only
# (tests/test_torch_adafactor.py holds the CPU against optax to the same)
ADAFACTOR_PARAM_RTOL = 1e-6
ADAFACTOR_STATE_RTOL = 1e-5


def phase_optimizer(device, steps=3):
    """Adafactor steps on the card against the same steps on the CPU, on
    a small fp32 tree from a seed, compared after each step: parameters
    within ADAFACTOR_PARAM_RTOL of each leaf's largest value, second
    moments within ADAFACTOR_STATE_RTOL of theirs."""
    from ray_tpu_torch.train import Adafactor
    from ray_tpu_torch.train.optim import factored_dims

    g = torch.Generator().manual_seed(5)
    names = sorted(ADAFACTOR_TREE)
    init = {k: scale * torch.randn(shape, generator=g)
            for k, (shape, scale) in ADAFACTOR_TREE.items()}
    grads = [{k: torch.randn(ADAFACTOR_TREE[k][0], generator=g)
              for k in names} for _ in range(steps)]
    runs = []                   # (parameters, optimizer): CPU, card
    for dev in (torch.device("cpu"), device):
        params = [init[k].to(dev, copy=True) for k in names]
        runs.append((params, Adafactor(params, lr=1e-3)))
    (cpu_p, cpu_opt), (dev_p, dev_opt) = runs
    worst = {"param": 0.0, "state": 0.0}
    for step in range(steps):
        for params, opt in runs:
            for p, k in zip(params, names):
                p.grad = grads[step][k].to(p.device)
            opt.step()
        for a, b in zip(dev_p, cpu_p):
            r = float((a.cpu() - b).abs().max() / b.abs().max())
            worst["param"] = max(worst["param"], r / ADAFACTOR_PARAM_RTOL)
            for key, sb in cpu_opt.state[b].items():
                if key == "step":
                    assert float(dev_opt.state[a][key]) == float(sb) \
                        == step + 1
                    continue
                sa = dev_opt.state[a][key].cpu()
                r = float((sa - sb).abs().max() / sb.abs().max())
                worst["state"] = max(worst["state"],
                                     r / ADAFACTOR_STATE_RTOL)
    kinds = {k: "factored" if factored_dims(ADAFACTOR_TREE[k][0])
             else "full" for k in names}
    log(f"Adafactor on the card vs the CPU ({steps} steps, fp32, leaves "
        f"{json.dumps(kinds)}): worst parameter {worst['param']:.3f} x its "
        f"limit ({ADAFACTOR_PARAM_RTOL:g} of the leaf's largest), worst "
        f"second moment {worst['state']:.3f} x its limit "
        f"({ADAFACTOR_STATE_RTOL:g})")
    assert worst["param"] <= 1 and worst["state"] <= 1, worst


# --------------------------------------------- phase 10: Mixtral training

MIXTRAL_CONFIG = {"n_layers": 2}    # mixtral_8x7b widths, 2 of 32 layers
MIXTRAL_BATCH = (4, 2048)           # B, L
MIXTRAL_WARMUP, MIXTRAL_STEPS = 2, 3
MIXTRAL_SELECTIVE_STEPS = 3         # the first one untimed
# the card-against-CPU oracle: Mixtral's vocab, heads and experts at a
# width the CPU runs in seconds
MIXTRAL_ORACLE = {"dim": 512, "n_heads": 8, "n_kv_heads": 2,
                  "ffn_dim": 1024, "n_layers": 2}
MIXTRAL_ORACLE_BATCH = (2, 256)
# fp32 on both devices, TF32 off: loss and aux within 1e-5 of themselves,
# each gradient within 1e-5 of its leaf's largest value (summation order
# only; tests/test_torch_mixtral.py holds the CPU against JAX to the same)
MIXTRAL_ORACLE_RTOL = 1e-5
ROUTING_BATCH = (1, 512)
# bf16 against fp32 routing of one model: a token whose fp32 gap between
# its 2nd and 3rd router probability exceeds this keeps its experts
ROUTING_MARGIN = 2.0 ** -5
MIXTRAL_GROUPS = ("expert products", "dispatch", "attention", "router",
                  "rest")
# ops of the MoE dispatch: the sort, the segment sizes, the gathers and
# the scatter-adds (and their backward); aten::index on 1-D inputs (the
# sorted weights; on 2-D it is the embedding's gather)
DISPATCH_OPS = ("aten::sort", "aten::argsort", "aten::bincount",
                "aten::index_select", "aten::index_add_",
                "aten::floor_divide")


@contextlib.contextmanager
def recording(module, name, keep):
    """While open, each call of ``module.name`` appends its result to
    ``keep``."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        keep.append(out)
        return out

    setattr(module, name, wrapper)
    try:
        yield keep
    finally:
        setattr(module, name, orig)


def port_launch_counts():
    """Every launch counter of the port's kernels."""
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.ops import paged_attention as tpa
    return {**tfa.launch_counts, **tpa.launch_counts}


def reset_port_launch_counts():
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.ops import paged_attention as tpa
    for counts in (tfa.launch_counts, tpa.launch_counts):
        for name in counts:
            counts[name] = 0


def mixtral_group(name, shapes, cfg, seq_len):
    """The group of MIXTRAL_GROUPS an op's device time belongs to, from
    its name and input shapes: the 2-D products with the expert width are
    the experts' (forward and backward), those with the expert count the
    router's; the batched products and the [.., L, L] score passes are
    attention's."""
    dims = {d for shape in shapes if isinstance(shape, (list, tuple))
            for d in shape if isinstance(d, int)}
    if name == "aten::mm":
        if cfg.ffn_dim in dims:
            return "expert products"
        return "router" if cfg.n_experts in dims else "rest"
    first = shapes[0] if shapes and isinstance(shapes[0], list) else []
    if name in DISPATCH_OPS or (name in ("aten::index", "aten::index_put_")
                                and len(first) == 1):
        return "dispatch"
    if name == "aten::bmm" or first[-2:] == [seq_len, seq_len]:
        return "attention"
    if len(first) == 2 and first[-1] == cfg.n_experts:
        return "router"
    return "rest"


def profile_mixtral_step(step, device, cfg, seq_len):
    """One train step under torch.profiler (ops with their input shapes,
    and the kernels): the device time of each of MIXTRAL_GROUPS (each op's
    own kernels; kernels linked to no op go to the rest), the busy time
    and its share of the profiled step's wall time, and the largest parts
    of the rest (ops by name, unlinked kernels by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        t0 = time.monotonic()
        step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    groups = dict.fromkeys(MIXTRAL_GROUPS, 0.0)
    rest, unlinked = {}, {}
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue        # a record_function range, on either side
        if e.device_type != DeviceType.CPU:         # a kernel
            unlinked[e.name] = unlinked.get(e.name, 0.0) + \
                e.device_time_total / 1e3
            continue
        for k in e.kernels:
            unlinked[k.name] = unlinked.get(k.name, 0.0) - k.duration / 1e3
        ms = sum(k.duration for k in e.kernels) / 1e3
        if ms > 0:
            group = mixtral_group(e.name, e.input_shapes, cfg, seq_len)
            groups[group] += ms
            if group == "rest":
                rest[e.name] = rest.get(e.name, 0.0) + ms
    for name, ms in unlinked.items():
        if ms > 1e-6:
            groups["rest"] += ms
            rest[f"kernel {name[:60]}"] = ms
    busy = sum(groups.values())
    top_rest = sorted(rest.items(), key=lambda kv: -kv[1])[:6]
    return groups, busy, busy / wall_ms, top_rest


def phase_mixtral(device, config=None, batch=MIXTRAL_BATCH, profile=True,
                  card="the CPU"):
    """make_train_step over the Mixtral loss at Mixtral-8x7B widths (cut in
    depth), remat "full" then "selective", on ``card`` (the nvidia-smi
    name and power limit, printed beside the times); returns the trained
    parameters and the configuration for the routing check."""
    from ray_tpu_torch.models import mixtral as tm
    from ray_tpu_torch.parallel import moe
    from ray_tpu_torch.train import make_train_step, profile_train_step

    cfg = tm.MixtralConfig.mixtral_8x7b(**(config or MIXTRAL_CONFIG))
    B, L = batch
    cuda = device.type == "cuda"
    t0 = time.monotonic()
    params = tm.init_params(cfg, seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, L), generator=g,
                           device=device)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in [params["embed"], params["final_norm"],
                                *params["layers"].values()])
    optimizer = make_optimizer("adafactor")
    train = {policy: make_train_step(functools.partial(
        tm.loss_fn, cfg=dataclasses.replace(cfg, remat_policy=policy)),
        optimizer) for policy in ("full", "selective")}
    opt = train["full"][0](params)
    log(f"Mixtral training: {tm.num_params(cfg)} parameters "
        f"({tm.active_params(cfg)} active), {cfg.n_layers} of 32 layers, "
        f"dim {cfg.dim}, {cfg.n_heads}/{cfg.n_kv_heads} heads, ffn "
        f"{cfg.ffn_dim}, {cfg.n_experts} experts top-{cfg.top_k}, B {B} L "
        f"{L}, adafactor {optimizer.keywords}; parameters {param_bytes} "
        f"bytes (fp32), gradients {param_bytes} bytes (fp32, between the "
        f"backward and the update), set-up {time.monotonic() - t0:.1f} s")
    reset_port_launch_counts()
    moe.sync_counts["segment_sizes"] = 0
    losses, runs, routed = [], {}, []
    for policy, warmup, steps in (
            ("full", MIXTRAL_WARMUP, MIXTRAL_STEPS),
            ("selective", 1, MIXTRAL_SELECTIVE_STEPS - 1)):
        step_fn = train[policy][1]
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(warmup + steps):
            last = policy == "full" and i == warmup + steps - 1
            t_step = time.monotonic()
            with (recording(tm, "_top_k", routed) if last
                  else contextlib.nullcontext()):
                params, opt, m = step_fn(params, opt, tokens)
            losses.append((float(m["loss"]), float(m["grad_norm"])))
            times.append(time.monotonic() - t_step)
        step_s = sum(times[warmup:]) / steps
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            total = torch.cuda.get_device_properties(device).total_memory
            assert peak < total, (policy, peak, total)
        runs[policy] = (step_s, peak, steps)
    syncs = moe.sync_counts["segment_sizes"]
    launches = port_launch_counts()
    assert all(math.isfinite(x) and math.isfinite(n)
               for x, n in losses), losses
    assert losses[-1][0] < losses[0][0], f"loss did not fall: {losses}"
    n_steps = MIXTRAL_WARMUP + MIXTRAL_STEPS + MIXTRAL_SELECTIVE_STEPS
    # the forward and the remat recompute each read the sizes once a layer
    assert syncs == 2 * cfg.n_layers * n_steps, syncs
    assert not any(launches.values()), launches
    state_bytes = sum(t.numel() * t.element_size()
                      for s in opt.state.values() for t in s.values()
                      if isinstance(t, torch.Tensor)
                      and t.device.type == device.type)
    per_expert = [torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
                  .tolist() for idx, _ in routed[:cfg.n_layers]]
    log(f"Mixtral training: losses {[round(x, 4) for x, _ in losses]}, "
        f"grad norms {[round(n, 4) for _, n in losses]}")
    for policy, (step_s, peak, steps) in runs.items():
        tok_s = B * L / step_s
        mfu = tok_s * tm.flops_per_token(cfg, L) / BF16_FLOPS
        log(f"Mixtral training (remat {policy}): step {step_s * 1e3:.1f} ms "
            f"(mean of {steps} timed), "
            f"{tok_s:.0f} tokens/s, MFU {mfu:.1%} of 989 TFLOP/s (H100 "
            f"SXM dense bf16 peak; flops_per_token on active parameters), "
            f"peak memory {peak} bytes (torch.cuda.max_memory_allocated); "
            f"{card}")
    log(f"Mixtral training: optimizer state {state_bytes} bytes on the "
        f"card; MoE segment-size reads {syncs} over {n_steps} steps "
        f"({syncs // n_steps} a step: forward + recompute per layer); port "
        f"kernel launches {sum(launches.values())}; tokens per expert per "
        f"layer at the last remat-full step {per_expert}")
    if profile:
        step_s = runs["full"][0]
        loss = functools.partial(tm.loss_fn, cfg=cfg)
        step_fn = train["full"][1]
        bd = profile_train_step(loss, optimizer, params, opt, tokens,
                                steps=2, warmup=1, emit=False)
        log(f"Mixtral training: profile_train_step step "
            f"{bd.step_time_s * 1e3:.1f} ms, phases ms "
            f"{json.dumps({k: round(x, 2) for k, x in bd.phase_ms().items()})}")
        groups, busy, share, top_rest = profile_mixtral_step(
            lambda: step_fn(params, opt, tokens), device, cfg, L)
        log(f"Mixtral training: one remat-full step under the profiler: "
            f"device busy {busy:.1f} ms = {share:.1%} of its wall time; "
            f"by group (ms, share of busy) " + json.dumps(
                {k: [round(v, 2), round(v / busy, 4) if busy else 0.0]
                 for k, v in groups.items()})
            + f"; largest in the rest (ms): "
            + json.dumps({k: round(v, 2) for k, v in top_rest}))
    assert not any(port_launch_counts().values())
    return params, cfg


def phase_mixtral_routing(device, params, cfg, batch=ROUTING_BATCH):
    """The bf16 model's top-k experts against its own fp32 forward, layer
    by layer, each run on its own activations, under no_grad. A token
    whose experts differ in one layer carries an O(1) difference into the
    next, so in each layer the tokens held to the margin are those whose
    experts agreed in every earlier layer."""
    from ray_tpu_torch.models import mixtral as tm

    g = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, batch, generator=g,
                           device=device)
    probs = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            with recording(tm, "_router_probs", probs.setdefault(dtype, [])):
                tm.forward(params, tokens,
                           dataclasses.replace(cfg, dtype=dtype))
    shares, worst, held = [], [], []
    agreed = torch.ones(batch[0] * batch[1], dtype=torch.bool,
                        device=device)
    for p16, p32 in zip(probs[torch.bfloat16], probs[torch.float32]):
        top16 = p16.topk(cfg.top_k, dim=-1).indices.sort(-1).values
        top32 = p32.topk(cfg.top_k + 1, dim=-1)
        gap = top32.values[:, -2] - top32.values[:, -1]
        same = (top16 == top32.indices[:, :-1].sort(-1).values).all(-1)
        shares.append(round(same.float().mean().item(), 4))
        differ = agreed & ~same
        worst.append(gap[differ].max().item() if differ.any() else 0.0)
        held.append(int((agreed & (gap > ROUTING_MARGIN)).sum()))
        agreed &= same
    log(f"Mixtral routing, bf16 vs fp32 at full width (B {batch[0]} L "
        f"{batch[1]}): tokens with the same top-{cfg.top_k}, per layer "
        f"{shares}; among tokens that agreed in every earlier layer, the "
        f"largest fp32 2nd/3rd gap of a token that differs, per layer "
        f"{[round(w, 5) for w in worst]}; margin {ROUTING_MARGIN:g}, "
        f"tokens held to it per layer {held}")
    assert max(worst) <= ROUTING_MARGIN, (worst, ROUTING_MARGIN)


def phase_mixtral_oracle(device, config=None, batch=MIXTRAL_ORACLE_BATCH):
    """A small fp32 Mixtral on ``device`` against the same parameters and
    tokens on the CPU: loss, aux, routing and every gradient."""
    r = mixtral_oracle_readings(device, config, batch)
    assert r["rel"][r["worst"]] <= MIXTRAL_ORACLE_RTOL, \
        {k: f"{v:.2e}" for k, v in r["rel"].items()}
    return r


def grads_digest(grads):
    """A short hash of a list of CPU tensors' bytes: equal digests, equal
    tensors to the bit."""
    import hashlib
    h = hashlib.sha1()
    for t in grads:
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:12]


def mixtral_oracle_readings(device, config=None,
                            batch=MIXTRAL_ORACLE_BATCH):
    """The oracle's computation (``phase_mixtral_oracle`` without its
    limit on the gradients): -> {"rel": {leaf: |card - cpu| max over the
    CPU's largest}, "worst": leaf, "card": digest, "cpu": digest} (the
    digests of each side's gradients, to tell which side moved between
    runs)."""
    from ray_tpu_torch.models import mixtral as tm
    from ray_tpu_torch.train import param_leaves

    cfg = tm.MixtralConfig.mixtral_8x7b(**(config or MIXTRAL_ORACLE),
                                        dtype=torch.float32)
    cpu = torch.device("cpu")
    init = tm.init_params(cfg, seed=3, device=cpu)
    tokens = torch.randint(0, cfg.vocab_size, batch,
                           generator=torch.Generator().manual_seed(4))
    results = {}
    for dev in (cpu, device):
        p = {k: v.to(dev, copy=True).requires_grad_()
             if isinstance(v, torch.Tensor) else
             {n: t.to(dev, copy=True).requires_grad_() for n, t in v.items()}
             for k, v in init.items()}
        routed, aux = [], []
        with recording(tm, "_top_k", routed), \
                recording(tm, "_aux_loss", aux):
            loss = tm.loss_fn(p, tokens.to(dev), cfg)
            loss.backward()
        results[dev.type] = (
            loss.item(), torch.stack(aux[:cfg.n_layers]).mean().item(),
            [i.cpu() for i, _ in routed[:cfg.n_layers]],
            [leaf.grad.cpu() for leaf in param_leaves(p)])
    (lc, ac, ic, gc), (ld, ad, idd, gd) = results["cpu"], \
        results[device.type]
    assert abs(ld - lc) <= MIXTRAL_ORACLE_RTOL * abs(lc), (ld, lc)
    assert abs(ad - ac) <= MIXTRAL_ORACLE_RTOL * abs(ac), (ad, ac)
    for a, b in zip(idd, ic):
        assert torch.equal(a.sort(-1).values, b.sort(-1).values)
    rel = {name: ((a - b).abs().max() / b.abs().max()).item()
           for name, a, b in zip(leaf_names(init), gd, gc)}
    worst = max(rel, key=rel.get)
    log(f"Mixtral oracle (dim {cfg.dim}, {cfg.n_experts} experts top-"
        f"{cfg.top_k}, {cfg.n_layers} layers, fp32, B {batch[0]} L "
        f"{batch[1]}): loss {ld:.7f} on the card vs {lc:.7f} on the CPU, "
        f"aux {ad:.7f} vs {ac:.7f}, routing equal, {len(gd)} gradients, "
        f"worst {rel[worst]:.2e} of the leaf's largest value ({worst}); "
        f"the CPU's sums on {torch.get_num_threads()} threads, "
        f"{torch.backends.cpu.get_cpu_capability()}; gradient digests "
        f"card {grads_digest(gd)}, CPU {grads_digest(gc)}")
    return {"rel": rel, "worst": worst, "card": grads_digest(gd),
            "cpu": grads_digest(gc)}


def leaf_names(params, prefix=""):
    """The dotted key of each leaf, in ``param_leaves``' order."""
    if isinstance(params, torch.Tensor):
        return [prefix]
    return [name for key in sorted(params) for name in
            leaf_names(params[key], f"{prefix}.{key}" if prefix else key)]


# ------------------------------------------------- phase 11: RL on the card

def rl_cases():
    """tests/test_rllib.py's settings and gates for each algorithm:
    name -> (config, most iterations, gate on the best episode-return
    mean). The model is RLlib's default module: a tanh MLP, hidden (64,
    64), policy and value heads (SAC: actor and twin critics)."""
    from ray_tpu_torch.rllib import (DQNConfig, IMPALAConfig, PPOConfig,
                                     SACConfig)
    return {
        "PPO": (PPOConfig(num_env_runners=2, num_envs_per_runner=16,
                          rollout_length=64, lr=1e-3, entropy_coeff=0.01,
                          num_epochs=4, minibatches=4, seed=3), 40, 100.0),
        "IMPALA": (IMPALAConfig(num_env_runners=2, num_envs_per_runner=16,
                                rollout_length=32, batches_per_iteration=8,
                                lr=1e-3, entropy_coeff=0.01, seed=0),
                   30, 120.0),
        "DQN": (DQNConfig(num_env_runners=2, num_envs_per_runner=8,
                          rollout_length=32, lr=1e-3, learning_starts=500,
                          updates_per_iter=16, target_sync_every=100,
                          epsilon_decay_iters=25, seed=1), 60, 100.0),
        "SAC": (SACConfig(num_env_runners=2, num_envs_per_runner=8,
                          rollout_length=32, lr=1e-3, learning_starts=512,
                          updates_per_iter=256, train_batch_size=256,
                          seed=0), 60, -350.0),
    }


# card against CPU: each leaf within 1e-5 of its largest value, the loss
# metric within 1e-5 of itself (the Mixtral oracle's limits)
RL_ORACLE_RTOL = 1e-5
# SAC's oracle update: 8 stacked batches, so that on the card the steps
# after the learner's 3 eager warm-up steps run as replays of its graph
RL_ORACLE_SAC_STEPS = 8


def runner_params(handle):
    """The parameters an EnvRunner actor holds (local mode: the actor's
    instance lives in this process)."""
    from ray_tpu_torch.core.worker import global_worker
    return global_worker.backend.actors[handle.actor_id].instance.params


def learner_call(name, algo, batch):
    """A thunk running one update of ``algo``'s learner on ``batch`` (its
    own replay sample for DQN and SAC)."""
    if name == "DQN":
        return lambda: algo.learner.update(algo.params, algo.target_params,
                                           batch)
    if name in ("PPO", "SAC"):
        return lambda: algo.learner.update(algo.params, batch, algo._gen)
    return lambda: algo.learner.update(algo.params, batch)


def learner_batch(name, algo):
    """A batch in the shape the algorithm's learner takes, from its own
    runners (PPO, IMPALA) or replay buffer (DQN, SAC)."""
    import numpy as np
    import ray_tpu_torch
    cfg = algo.config
    if name == "DQN":
        return algo.buffer.sample(cfg.train_batch_size)
    if name == "SAC":
        stack = [algo.buffer.sample(cfg.train_batch_size)
                 for _ in range(cfg.updates_per_iter)]
        return {k: np.stack([s[k] for s in stack]) for k in stack[0]}
    if name == "IMPALA":
        ready, _ = ray_tpu_torch.wait(list(algo._inflight), num_returns=1,
                                      timeout=600)
        return ray_tpu_torch.get(ready[0])
    algo._broadcast_weights()
    batches = ray_tpu_torch.get([r.sample.remote() for r in algo.runners],
                                timeout=600)
    batch = {k: np.concatenate([b[k] for b in batches], axis=1)
             for k in ("obs", "actions", "logp", "values", "rewards",
                       "dones")}
    batch["last_value"] = np.concatenate([b["last_value"] for b in batches])
    return batch


def check_runner_snapshot(algo, batch_update):
    """The weights a runner holds share no storage with the learner's and
    do not change across the learner's next update."""
    from ray_tpu_torch.rllib.module import snapshot
    from ray_tpu_torch.train import param_leaves
    held = runner_params(algo.runners[0])
    before = snapshot(held)
    ptrs = {t.data_ptr() for t in param_leaves(algo.params)}
    assert not ptrs & {t.data_ptr() for t in param_leaves(held)}
    new, _ = batch_update()
    assert any(not torch.equal(a, b) for a, b in zip(
        param_leaves(new), param_leaves(algo.params)))
    for a, b in zip(param_leaves(held), param_leaves(before)):
        assert torch.equal(a, b), "a runner's weights moved with the learner"


def rl_oracle(name, params, batch, device, target=None):
    """One update of a fresh ``name`` learner on the card and on the CPU,
    from the same parameters and batch, with the same permutations (PPO)
    or noise (SAC): -> the worst leaf ratio and the loss metric's, each
    against RL_ORACLE_RTOL (at most 1 passes)."""
    import numpy as np
    from ray_tpu_torch.rllib import dqn, impala, learner, sac
    from ray_tpu_torch.rllib.env import PendulumVectorEnv
    from ray_tpu_torch.rllib.module import tree_map
    from ray_tpu_torch.train import param_leaves
    g = torch.Generator().manual_seed(11)
    if name == "PPO":
        n = batch["rewards"].size
        perms = torch.stack([torch.randperm(n, generator=g)
                             for _ in range(4)]).numpy()
    if name == "SAC":
        batch = {k: v[:RL_ORACLE_SAC_STEPS] for k, v in batch.items()}
        noise = {k: torch.randn(batch["actions"].shape, generator=g).numpy()
                 for k in ("next", "actor")}
    out = {}
    for dev in (torch.device("cpu"), device):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        if name == "PPO":
            new, m = learner.PPOLearner(lr=1e-3).update(p, batch,
                                                        perms=perms)
        elif name == "IMPALA":
            new, m = impala.IMPALALearner(lr=1e-3).update(p, batch)
        elif name == "DQN":
            t = tree_map(lambda t: t.to(dev, copy=True), target)
            new, m = dqn.DQNLearner(lr=1e-3).update(p, t, batch)
        else:
            new, m = sac.SACLearner(
                lr=1e-3, action_scale=PendulumVectorEnv.action_scale
            ).update(p, batch, noise=noise)
        out[dev.type] = ([t.cpu() for t in param_leaves(new)],
                         m["critic_loss" if name == "SAC" else "loss"])
    (want, lw), (got, lg) = out["cpu"], out[device.type]
    # a leaf that stays 0 on both (a head the loss does not reach) is 0
    leaf = max(((a - b).abs().max() / (RL_ORACLE_RTOL * b.abs().max()
                                       .clamp_min(1e-30))).item()
               for a, b in zip(got, want))
    assert np.isfinite(lg)
    return leaf, abs(lg - lw) / (RL_ORACLE_RTOL * abs(lw))


#: algorithm -> (iteration, sampling, learner update) mean ms of phase
#: 11's run, for phase 14e's comparison
RL_SPLITS = {}


def phase_rl(device, card="the CPU", cases=None):
    """RLlib on ``device`` through the user's entry points: the port's
    local-mode runtime, then each algorithm's ``build(device=)`` and
    ``train()`` until its gate, with every port launch counter set to 0
    just before and read just after (no Pallas kernel lies on this path,
    so all must stay 0); per algorithm the iteration time split into
    sampling and the learner update, the update on its own, one profiled
    update's device busy share, the weight-snapshot check and the card
    against the CPU. Returns {name: (iterations, best mean)}."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib.module import snapshot
    cases = cases if cases is not None else rl_cases()
    t_phase = time.monotonic()
    reset_port_launch_counts()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    out = {}
    try:
        for name, (config, iterations, gate) in cases.items():
            algo = config.build(device=device)
            try:
                t0 = time.monotonic()
                best, results, it_ms = float("-inf"), [], []
                for _ in range(iterations):
                    t = time.monotonic()
                    results.append(algo.train())
                    it_ms.append((time.monotonic() - t) * 1e3)
                    mean = results[-1]["episode_return_mean"]
                    if mean == mean:
                        best = max(best, mean)
                    if best >= gate:
                        break
                train_s = time.monotonic() - t0
                sample_ms = [r["time_sample_s"] * 1e3 for r in results]
                learn_ms = [r["time_learn_s"] * 1e3 for r in results]
                batch = learner_batch(name, algo)
                update = learner_call(name, algo, batch)
                if name == "IMPALA":
                    ray_tpu_torch.wait(list(algo._inflight),
                                       num_returns=len(algo._inflight),
                                       timeout=600)
                update()
                alone = []
                for _ in range(3):
                    t = time.monotonic()
                    update()
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    alone.append((time.monotonic() - t) * 1e3)
                alone_ms = sum(alone) / len(alone)
                _, busy = profile_device(update, device, alone_ms)
                check_runner_snapshot(algo, update)
                leaf, loss = rl_oracle(
                    name, snapshot(algo.params), batch, device,
                    snapshot(algo.target_params) if name == "DQN" else None)
            finally:
                algo.stop()
            log(f"RL {name}: best episode-return mean {best:.2f} after "
                f"{len(results)} iterations (gate {gate}, at most "
                f"{iterations}), {train_s:.2f} s; iteration ms mean "
                f"{sum(it_ms) / len(it_ms):.2f} (sampling, the get on the "
                f"runners, {sum(sample_ms) / len(sample_ms):.2f}; learner "
                f"update {sum(learn_ms) / len(learn_ms):.2f}); learner "
                f"update alone {alone_ms:.2f} ms (mean of 3); one profiled "
                f"update: {busy}; card against CPU: worst leaf "
                f"{leaf * RL_ORACLE_RTOL:.2e} of its largest value, loss "
                f"{loss * RL_ORACLE_RTOL:.2e} of itself; runner snapshot "
                f"held; {card}")
            assert best >= gate, f"{name} failed to learn: best {best}"
            assert leaf <= 1 and loss <= 1, (name, leaf, loss)
            out[name] = (len(results), best)
            RL_SPLITS[name] = (sum(it_ms) / len(it_ms),
                               sum(sample_ms) / len(sample_ms),
                               sum(learn_ms) / len(learn_ms))
    finally:
        ray_tpu_torch.shutdown()
    launches = port_launch_counts()
    assert not any(launches.values()), launches
    log(f"RL phase: {time.monotonic() - t_phase:.1f} s, port kernel "
        f"launches {sum(launches.values())}; {card}")
    return out


# ---------------------------- phase 12: data, batch inference and BC


#: (engine, seconds its predictor took to build) for each predictor the
#: pool built in this process (local mode: the pool's actors are threads
#: here), for the engines' step counts
PREDICTOR_ENGINES = []
DATA_ROWS, DATA_BLOCKS, DATA_NEW_TOKENS = 16, 4, 32
# 12a's prompts: 5 to 1,000 tokens at the 8B widths (max_seq_len 2048);
# 12b's: 5 to 400 at the bench widths (max_seq_len 512)
DATA_LENGTHS = (5, 1000)
DATA_BENCH_LENGTHS = (5, 400)
# BC on the card (tests/test_rllib.py:239): a PPO teacher (rl_cases'
# PPO) to its gate, 8192 recorded rows, then BC to 100 within 15
# iterations; one BC update on the card against the CPU as phase 11's
BC_ROWS, BC_ITERATIONS, BC_GATE = 8192, 15, 100.0
BC_CONFIG = dict(lr=1e-3, batch_size=512, seed=11)


def counting_predictor():
    """``LLMBatchPredictor`` that puts its engine and its build time in
    PREDICTOR_ENGINES, so that the phase reads the engine's step counts
    once the pool is gone.
    The data layer cloudpickles the class, by value for a class of the
    script run as ``__main__``, so the list is looked up through the
    class's module when the pool's actor constructs it."""
    from ray_tpu_torch.llm.batch import LLMBatchPredictor

    class CountingPredictor(LLMBatchPredictor):
        def __init__(self, *args, **kwargs):
            t0 = time.monotonic()
            super().__init__(*args, **kwargs)
            sys.modules[type(self).__module__].PREDICTOR_ENGINES.append(
                (self.engine, time.monotonic() - t0))

    return CountingPredictor


def data_rows(vocab, lengths):
    """DATA_ROWS rows ``{"prompt": token ids, "id": j}``, prompt lengths
    spread evenly over ``lengths`` (the smallest and largest)."""
    lo, hi = lengths
    return [{"prompt": _prompt(40 + j, lo + (hi - lo) * j // (DATA_ROWS - 1),
                               vocab), "id": j} for j in range(DATA_ROWS)]


def expected_ragged_launches(engines):
    """Phase 4's count, summed over ``engines``: per layer, one launch a
    ragged step and decode_chunk a decode dispatch."""
    return sum(e.cfg.n_layers * (e.stats["ragged_dispatches"]
                                 + e.decode_chunk
                                 * e.stats["decode_dispatches"])
               for e in engines)


def run_batch_inference(rows, model_config, engine_config, concurrency):
    """``batch_inference`` over ``rows`` in DATA_BLOCKS blocks through
    ActorPoolStrategy(concurrency), every launch counter set to 0 just
    before and read just after: -> the output rows, the stage's
    ExecStats, the pool's engines, the launches, the stage's wall seconds
    and the seconds its predictors took to build (inside the stage). The
    runtime must be up."""
    from unittest import mock

    from ray_tpu_torch import data as rd
    from ray_tpu_torch.llm import batch as tbatch
    PREDICTOR_ENGINES.clear()
    ds = rd.from_items(rows, num_blocks=DATA_BLOCKS)
    with mock.patch.object(tbatch, "LLMBatchPredictor",
                           counting_predictor()):
        out_ds = tbatch.batch_inference(
            ds, model_config=model_config, engine_config=engine_config,
            max_new_tokens=DATA_NEW_TOKENS, concurrency=concurrency)
    reset_port_launch_counts()
    t0 = time.monotonic()
    out = out_ds.take_all()
    wall = time.monotonic() - t0
    launches = port_launch_counts()
    engines = [e for e, _ in PREDICTOR_ENGINES]
    build_s = [s for _, s in PREDICTOR_ENGINES]
    PREDICTOR_ENGINES.clear()
    assert [r["id"] for r in out] == [r["id"] for r in rows]
    for row, got in zip(rows, out):
        assert got["prompt"] == row["prompt"], row["id"]
        assert len(got["generated"]) == DATA_NEW_TOKENS \
            or got["finish_reason"] == "stop", got
    return out, out_ds.stats(), engines, launches, wall, build_s


def log_stage(name, out, stats, engines, wall, build_s):
    n_tok = sum(len(r["generated"]) for r in out)
    log(f"{name}: {len(out)} rows in {wall:.2f} s ({len(out) / wall:.2f} "
        f"rows/s, {n_tok / wall:.1f} generated tokens/s; the predictors' "
        f"builds inside the stage {[round(s, 2) for s in build_s]} s), the "
        f"stage's ExecStats {json.dumps(stats)}, {len(engines)} engines, "
        f"stats {[dict(e.stats) for e in engines]}")


def phase_batch_inference(model_config=None, engine_config=None,
                          lengths=DATA_LENGTHS):
    """12a: ``batch_inference`` at the main path's widths (phase 4's
    model and engine), DATA_ROWS rows in DATA_BLOCKS blocks through one
    pool actor; the ragged launches equal the pool's engine's count, the
    plain version never runs on CUDA tensors, and every row's tokens and
    finish reason equal ``LLMBatchPredictor`` called directly on the
    same blocks with the same weights (the engine's seed), built once
    the pool's engine is gone. Returns the launches and their count."""
    import gc

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.llm.batch import LLMBatchPredictor
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    model_config = model_config or MAIN_MODEL
    engine_config = engine_config or MAIN_ENGINE
    cuda = torch.device(engine_config.get("device", "cuda")).type == "cuda"
    t_phase = time.monotonic()
    cfg = model_config_from_dict(model_config)
    rows = data_rows(cfg.vocab_size, lengths)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        out, stats, engines, launches, wall, build_s = run_batch_inference(
            rows, model_config, engine_config, concurrency=1)
        expected = expected_ragged_launches(engines)
        log_stage(f"batch_inference ({cfg.n_layers} layers dim {cfg.dim} "
                  f"{cfg.dtype}, prompts of {lengths[0]}-{lengths[1]} "
                  f"tokens x {DATA_NEW_TOKENS} new, ActorPoolStrategy(1))",
                  out, stats, engines, wall, build_s)
        del engines
    finally:
        ray_tpu_torch.shutdown()        # the pool's actors and engine go
    gc.collect()
    peak_pool = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    pred = LLMBatchPredictor(model_config, engine_config,
                             max_new_tokens=DATA_NEW_TOKENS)
    direct_build_s = time.monotonic() - t0
    bounds = np.linspace(0, len(rows), DATA_BLOCKS + 1).astype(int)
    t0 = time.monotonic()
    direct = [r for lo, hi in zip(bounds[:-1], bounds[1:])
              for r in pred(rows[lo:hi])]
    direct_s = time.monotonic() - t0
    peak_direct = torch.cuda.max_memory_allocated() if cuda else 0
    del pred
    gc.collect()
    for got, want in zip(out, direct):
        assert got == want, (got["id"], got["generated"], want["generated"])
    log(f"batch_inference: launches {launches}, expected "
        f"ragged_paged_attention {expected}; every row equal to the "
        f"direct predictor's on the same blocks, which took "
        f"{direct_s:.2f} s after a {direct_build_s:.2f} s build, against "
        f"the stage's {wall:.2f} s, its build included (finish reasons "
        f"{sorted({r['finish_reason'] for r in out})}); peak memory "
        f"{peak_pool} bytes with the pool, {peak_direct} with the direct "
        f"predictor; phase 12a {time.monotonic() - t_phase:.1f} s")
    return launches, expected


def phase_batch_rows(model_config=None, engine_config=None,
                     lengths=DATA_BENCH_LENGTHS):
    """12b: ``batch_inference`` at the bench widths in fp32 through
    ActorPoolStrategy(2) (two engines at once, one per pool actor): every
    row's tokens and finish reason equal the engine's ``generate`` on
    that prompt alone (phase 5b's rule: fp32 rows differ by summation
    order only); the ragged launches equal both engines' counts. Returns
    the launches and their count."""
    import ray_tpu_torch
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    model_config = model_config or {**BENCH_MODEL, "dtype": "float32"}
    engine_config = engine_config or BENCH_ENGINE
    t_phase = time.monotonic()
    cfg = model_config_from_dict(model_config)
    rows = data_rows(cfg.vocab_size, lengths)
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        out, stats, engines, launches, wall, build_s = run_batch_inference(
            rows, model_config, engine_config, concurrency=2)
        expected = expected_ragged_launches(engines)
        log_stage(f"batch_inference at the bench widths ({cfg.n_layers} "
                  f"layers, {cfg.dtype}, ActorPoolStrategy(2))", out,
                  stats, engines, wall, build_s)
        assert len(engines) == 2, len(engines)
        alone = InferenceEngine(cfg, engines[0].params, **engine_config)
        del engines
    finally:
        ray_tpu_torch.shutdown()
    for row, got in zip(rows, out):
        want = alone.generate(row["prompt"], DATA_NEW_TOKENS)
        reason = alone.request_log.snapshot()[-1]["finish_reason"]
        assert got["generated"] == want, (row["id"], got["generated"], want)
        assert got["finish_reason"] == reason, (got["finish_reason"], reason)
    log(f"batch_inference at the bench widths: launches {launches}, "
        f"expected ragged_paged_attention {expected} (both engines); every "
        f"row equal to generate alone; phase 12b "
        f"{time.monotonic() - t_phase:.1f} s")
    return launches, expected


def phase_bc(device, teacher=None, iterations=BC_ITERATIONS, gate=BC_GATE,
             rows=BC_ROWS, card="the CPU"):
    """12c: BC through the user's entry points on ``device``: a PPO
    teacher (``teacher``: (config, most iterations, gate), rl_cases' PPO
    by default) trained to its gate, ``record_dataset`` of ``rows`` rows
    (obs fp32, action int32), then ``BCConfig(...).build(device=)``
    trained until its best mean reaches ``gate`` within ``iterations``;
    every port launch counter stays 0 (no Pallas kernel lies on this
    path); the epoch's time split into batch iteration and updates; one
    BC update on ``device`` against the CPU. Returns a summary."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.rllib import BCConfig, BCLearner, record_dataset
    from ray_tpu_torch.rllib.module import snapshot, tree_map
    from ray_tpu_torch.train import param_leaves
    config, teacher_iterations, teacher_gate = teacher or rl_cases()["PPO"]
    t_phase = time.monotonic()
    reset_port_launch_counts()
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    try:
        ppo = config.build(device=device)
        try:
            teacher_best, n_teacher = float("-inf"), 0
            while n_teacher < teacher_iterations and \
                    teacher_best < teacher_gate:
                mean = ppo.train()["episode_return_mean"]
                n_teacher += 1
                if mean == mean:
                    teacher_best = max(teacher_best, mean)
            assert teacher_best >= teacher_gate, \
                f"teacher PPO failed to learn: best {teacher_best}"
            t_rec = time.monotonic()
            ds = record_dataset(ppo, num_samples=rows)
            record_s = time.monotonic() - t_rec
        finally:
            ppo.stop()
        assert ds.count() == rows
        first = next(ds.iter_batches(batch_size=BC_CONFIG["batch_size"],
                                     drop_last=True))
        assert first["obs"].dtype == np.float32 and \
            first["action"].dtype == np.int32, first
        bc = BCConfig(dataset=ds, **BC_CONFIG).build(device=device)
        try:
            best, results = float("-inf"), []
            for _ in range(iterations):
                results.append(bc.train())
                mean = results[-1]["episode_return_mean"]
                if mean == mean:
                    best = max(best, mean)
                if best >= gate:
                    break
            params = snapshot(bc.params)
        finally:
            bc.stop()
    finally:
        ray_tpu_torch.shutdown()
    launches = port_launch_counts()
    assert not any(launches.values()), launches
    out = {}
    for dev in (torch.device("cpu"), device):
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        learner = BCLearner(lr=BC_CONFIG["lr"])
        learner.init(p)
        new, m = learner.update(p, first)
        out[dev.type] = ([t.cpu() for t in param_leaves(new)],
                         m["bc_loss"])
    (want, lw), (got, lg) = out["cpu"], out[device.type]
    # a leaf that stays 0 on both (a head the loss does not reach) is 0
    leaf = max(((a - b).abs().max() / (RL_ORACLE_RTOL * b.abs().max()
                                       .clamp_min(1e-30))).item()
               for a, b in zip(got, want))
    loss = abs(lg - lw) / (RL_ORACLE_RTOL * abs(lw))
    data_ms = [r["time_data_s"] * 1e3 for r in results]
    learn_ms = [r["time_learn_s"] * 1e3 for r in results]
    it_ms = [r["time_this_iter_s"] * 1e3 for r in results]
    log(f"BC: teacher PPO best {teacher_best:.2f} after {n_teacher} "
        f"iterations; record_dataset {rows} rows in {record_s:.2f} s; BC "
        f"best episode-return mean {best:.2f} after {len(results)} "
        f"iterations (gate {gate}, at most {iterations}); epoch of "
        f"{rows // BC_CONFIG['batch_size']} batches: iteration ms mean "
        f"{sum(it_ms) / len(it_ms):.2f} (batch iteration "
        f"{sum(data_ms) / len(data_ms):.2f}, learner updates "
        f"{sum(learn_ms) / len(learn_ms):.2f}, the rest greedy "
        f"evaluation); update card against CPU: worst leaf "
        f"{leaf * RL_ORACLE_RTOL:.2e} of its largest value, loss "
        f"{loss * RL_ORACLE_RTOL:.2e} of itself; port kernel launches "
        f"{sum(launches.values())}; phase 12c "
        f"{time.monotonic() - t_phase:.1f} s; {card}")
    assert best >= gate, f"BC failed to reach the gate: best {best}"
    assert leaf <= 1 and loss <= 1, (leaf, loss)
    return {"teacher_best": teacher_best, "bc_best": best,
            "bc_iterations": len(results), "leaf": leaf}


# ----------------------------- phase 13: Tune PBT over the train step

# phase 7's widths cut to 2 of its 8 layers; fp32 master weights from
# seed 0, bf16 compute, Adafactor(lr=cfg["lr"]), B 2 x L 2048 from seed 1
TUNE_CONFIG = dict(TRAIN_CONFIG, n_layers=2)
TUNE_BATCH = (2, 2048)
TUNE_LRS = (1e-3, 1e-3, 3e-1, 3e-1)
TUNE_ITERATIONS = 4             # reports per trial
TUNE_STEPS_PER_REPORT = 2
TUNE_INTERVAL = 2               # PBT's perturbation interval
# losses of the same forward pass on the same weights and batch: equal
# up to fp32 noise of the loss's own size
TUNE_LOSS_RTOL = 1e-6


def tune_trainable(device, config, batch, events, extra=None):
    """A Tune trainable over ``make_train_step``: each report is
    TUNE_STEPS_PER_REPORT steps; ``loss`` is the first step's (the
    forward pass on the weights the report starts from). At every
    TUNE_INTERVAL-th iteration the report carries a checkpoint of the
    state that iteration started from (params and Adafactor state), so
    a trial restored from it runs that iteration again, from the same
    weights, with its new lr. ``events`` gets ("step", lr, ms),
    ("save", s) and ("load", s) as they happen (local mode passes the
    trainable by reference), so steps a stopped trial ran without
    reporting them count too. ``extra()`` (when given) adds its dict to
    each report."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.rllib.module import snapshot
    from ray_tpu_torch.train import Adafactor, make_train_step
    mcfg = LlamaConfig(**config)
    B, L = batch

    def trainable(cfg):
        import copy
        g = torch.Generator(device=device).manual_seed(1)
        tokens = torch.randint(0, mcfg.vocab_size, (B, L), generator=g,
                               device=device)
        init_fn, step_fn = make_train_step(
            functools.partial(loss_fn, cfg=mcfg),
            functools.partial(Adafactor, lr=cfg["lr"]))
        t = time.monotonic()
        state = tune.get_checkpoint()
        if state is None:
            params, done = init_params(mcfg, seed=0, device=device), 0
        else:
            events.append(("load", time.monotonic() - t))
            params, done = state["params"], state["iteration"]
        opt = init_fn(params)
        if state is not None:
            opt.load_state_dict(state["opt"])
            for group in opt.param_groups:
                group["lr"] = cfg["lr"]
        del state
        for it in range(done + 1, TUNE_ITERATIONS + 1):
            ckpt = None if it % TUNE_INTERVAL else {
                "params": snapshot(params),
                "opt": copy.deepcopy(opt.state_dict()), "iteration": it - 1}
            losses, ms = [], []
            for _ in range(TUNE_STEPS_PER_REPORT):
                t = time.monotonic()
                params, opt, m = step_fn(params, opt, tokens)
                losses.append(float(m["loss"]))            # syncs
                ms.append((time.monotonic() - t) * 1e3)
                events.append(("step", cfg["lr"], ms[-1]))
            t = time.monotonic()
            tune.report({"loss": losses[0], "losses": losses, "iter": it,
                         "step_ms": ms, "lr": cfg["lr"],
                         **(extra() if extra else {})}, checkpoint=ckpt)
            if ckpt is not None:
                events.append(("save", time.monotonic() - t))
            del ckpt

    return trainable


def recording_pbt(**kwargs):
    """``PopulationBasedTraining`` that records each exploit it decides:
    the trial, how many results it had, the donor and the donor's result
    that came with the checkpoint handed over (the newest of a
    checkpointing iteration)."""
    from ray_tpu_torch.tune import PopulationBasedTraining

    class RecordingPBT(PopulationBasedTraining):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.exploits = []

        def on_result(self, trial, result, all_trials):
            decision = super().on_result(trial, result, all_trials)
            directive = getattr(trial, "_pbt_exploit", None)
            if directive is not None:
                donor = next(t for t in all_trials
                             if t.trial_id == directive["source_id"])
                donor_result = [r for r in donor.results
                                if r["iter"] % TUNE_INTERVAL == 0][-1]
                self.exploits.append({
                    "trial": trial.trial_id, "at": len(trial.results),
                    "donor": donor.trial_id,
                    "donor_result": dict(donor_result),
                    "lr": directive["config"]["lr"]})
            return decision

    return RecordingPBT(**kwargs)


def phase_tune(device, config=None, batch=TUNE_BATCH, lrs=TUNE_LRS):
    """Tune's PBT over the train step on ``device``: len(lrs) trials, 2
    at once, TUNE_ITERATIONS reports each; the flash launch counters set
    to 0 before and read after must equal expected_flash_launches over
    the steps the trials ran (on a CUDA device; on the CPU the plain
    versions run and all stay 0); trial 0's first two losses equal a
    standalone run's; every exploited trial's first loss equals its
    donor's at that iteration; the trials that started at the largest lr
    end lower than their last loss before their exploit. Returns a
    summary."""
    import os
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.llama import (LlamaConfig, init_params,
                                            loss_fn, num_params)
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.train import Adafactor, make_train_step
    config = config or TUNE_CONFIG
    mcfg = LlamaConfig(**config)
    B, L = batch
    cuda = device.type == "cuda"
    t_phase = time.monotonic()
    # the standalone run: trial 0's configuration and lr outside Tune
    params = init_params(mcfg, seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, mcfg.vocab_size, (B, L), generator=g,
                           device=device)
    init_fn, step_fn = make_train_step(functools.partial(loss_fn, cfg=mcfg),
                                       functools.partial(Adafactor,
                                                         lr=lrs[0]))
    opt = init_fn(params)
    alone, alone_ms = [], []
    for _ in range(2 * TUNE_STEPS_PER_REPORT):
        t = time.monotonic()
        params, opt, m = step_fn(params, opt, tokens)
        alone.append(float(m["loss"]))
        alone_ms.append((time.monotonic() - t) * 1e3)
    del params, opt, m
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    events = []
    scheduler = recording_pbt(
        perturbation_interval=TUNE_INTERVAL, quantile_fraction=0.5,
        hyperparam_mutations={"lr": tune.loguniform(1e-4, 3e-3)}, seed=0)
    for name in tfa.launch_counts:
        tfa.launch_counts[name] = 0
    try:
        ray_tpu_torch.init(local_mode=True, num_cpus=4)
        try:
            t_fit = time.monotonic()
            grid = tune.Tuner(
                tune_trainable(device, config, batch, events),
                param_space={"lr": tune.grid_search(list(lrs))},
                tune_config=tune.TuneConfig(metric="loss", mode="min",
                                            scheduler=scheduler,
                                            max_concurrent_trials=2),
                run_config=tune.TuneRunConfig(
                    storage_path=storage,
                    resources_per_trial={"CPU": 1, "GPU": 1})).fit()
            fit_s = time.monotonic() - t_fit
        finally:
            # joins the trial actors, which wait for their functions'
            # threads
            ray_tpu_torch.shutdown()
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, files in os.walk(storage) for f in files
                         if f.startswith("ckpt_"))
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    launches = dict(tfa.launch_counts)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    steps = [e for e in events if e[0] == "step"]
    saves = [e[1] for e in events if e[0] == "save"]
    loads = [e[1] for e in events if e[0] == "load"]
    assert not grid.errors, [t.error for t in grid.errors]
    log(f"tune: PBT over make_train_step, {num_params(mcfg)} parameters "
        f"({mcfg.n_layers} layers dim {mcfg.dim}, {mcfg.attention}, remat "
        f"{mcfg.remat_policy}), B {B} L {L}, {len(lrs)} trials lr {lrs}, "
        f"2 at once, {TUNE_ITERATIONS} reports of {TUNE_STEPS_PER_REPORT} "
        f"steps; fit {fit_s:.1f} s, {len(steps)} steps run")
    for trial in grid.trials:
        step_ms = [x for r in trial.results for x in r["step_ms"][1:]]
        log(f"tune: {trial.trial_id} lr {trial.results[0]['lr']} -> "
            f"{trial.config['lr']:.3g}: (iter, loss) "
            f"{[(r['iter'], round(r['loss'], 5)) for r in trial.results]}, "
            f"step ms (each after the first of a report) "
            f"{sum(step_ms) / len(step_ms):.1f}")
    log(f"tune: exploits {scheduler.exploits}")
    log(f"tune: checkpoints {len(saves)}, {ckpt_bytes} bytes written, "
        f"pickling {sum(saves):.2f} s ({[round(s, 2) for s in saves]}), "
        f"loading {sum(loads):.2f} s ({[round(s, 2) for s in loads]})")
    log(f"tune: step ms alone {sum(alone_ms[2:]) / 2:.1f} (steps 3-4 of "
        f"the standalone run); peak memory {peak} bytes with the trials "
        f"on the card; flash launches {launches}")
    # the steps the trials ran, and the kernels they launched
    if cuda:
        assert launches == expected_flash_launches(mcfg.n_layers,
                                                   len(steps)), launches
    else:
        assert not any(launches.values()), launches
    first = grid.trials[0].results[0]["losses"]
    for got, want in zip(first, alone[:2]):
        assert abs(got - want) <= TUNE_LOSS_RTOL * abs(want), (first, alone)
    by_id = {t.trial_id: t for t in grid.trials}
    for e in scheduler.exploits:
        after = by_id[e["trial"]].results[e["at"]]
        want = e["donor_result"]
        assert after["iter"] == want["iter"], (e, after)
        assert abs(after["loss"] - want["loss"]) <= \
            TUNE_LOSS_RTOL * abs(want["loss"]), (e, after)
    top = max(lrs)
    for trial in grid.trials:
        if trial.results[0]["lr"] != top:
            continue
        mine = [e for e in scheduler.exploits if e["trial"] ==
                trial.trial_id]
        assert mine, f"{trial.trial_id} (lr {top}) was never exploited"
        before = trial.results[mine[0]["at"] - 1]["loss"]
        assert trial.results[-1]["loss"] < before, \
            (trial.trial_id, before, trial.results[-1]["loss"])
    log(f"tune: trial 0's first losses {first} equal the standalone run's "
        f"{alone[:2]}; {len(scheduler.exploits)} exploits, each first "
        f"loss equal to its donor's; phase 13 "
        f"{time.monotonic() - t_phase:.1f} s")
    return {"steps": len(steps), "exploits": scheduler.exploits,
            "launches": launches}


# ------------------------- phase 14: the cluster runtime on the card

CLUSTER_CPUS = 4
#: the shm arena of phase 14's cluster: 14d's 1 GiB tensor and the
#: actor's returns fit at once
CLUSTER_STORE_BYTES = 3 << 30
BIG_TENSOR_BYTES = 1 << 30
#: free device memory once a killed GPU worker's process has ended may
#: lie at most this far under the free memory before it started (the
#: driver's own allocations between the two readings are none)
MEMORY_RETURN_SLACK = 256 << 20


class MainServer:
    """Phase 14's actor (``remote(num_gpus=1)``): phase 4's ``LLMServer``
    in a worker process of the cluster runtime, which sees only its
    leased card. ``build=False`` defers the server to ``build()``, so the
    worker touches no device until asked."""

    def __init__(self, model_config, engine_config, build=True):
        import os
        self.t_enter = time.time()
        self.pid = os.getpid()
        self.model_config, self.engine_config = model_config, engine_config
        self.srv = None
        self.build_s = None
        if build:
            self.build()

    def where(self):
        """-> pid, CUDA_VISIBLE_DEVICES, when the process started and
        when __init__ was entered (touches no device)."""
        import os
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return {"pid": self.pid, "t_enter": self.t_enter,
                "t_start": time.time() - age,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "build_s": self.build_s}

    def build(self):
        from ray_tpu_torch.llm.serve_llm import LLMServer
        from ray_tpu_torch.ops import paged_attention as tpa
        t0 = time.monotonic()
        self.srv = LLMServer(self.model_config, self.engine_config)
        if self.srv.engine.device.type == "cuda":
            torch.cuda.synchronize()
        self.build_s = time.monotonic() - t0
        # counted from 0 after construction
        for name in tpa.launch_counts:
            tpa.launch_counts[name] = 0
        return self.build_s

    def device(self):
        dev = self.srv.engine.device
        if dev.type != "cuda":
            return {"type": dev.type}
        return {"type": "cuda", "name": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
                "peak_allocated": torch.cuda.max_memory_allocated(),
                "reserved": torch.cuda.memory_reserved()}

    def answer(self):
        """Phase 4's requests, sent as phase 4 sends them: the first wave
        from one thread each, admitted at one step, then the prefix hit
        alone. -> the token streams and each request's wall seconds."""
        srv, eng = self.srv, self.srv.engine
        reqs, hit_req = main_requests(eng.cfg.vocab_size, eng.prefill_chunk)
        out = {"wave": [None] * len(reqs), "e2e_s": {}}

        def run(i, kind, prompt, max_tokens):
            t = time.monotonic()
            body = {"prompt_ids": prompt, "max_tokens": max_tokens}
            if kind == "call":
                toks = srv(body)["token_ids"]
            else:
                toks = []
                for item in srv.stream(body):
                    if item.get("done"):
                        break
                    toks += item["token_ids"]
            out["wave"][i] = toks
            out["e2e_s"][i] = time.monotonic() - t

        admit_together(eng, len(reqs))
        threads = [threading.Thread(target=run, args=(i, *r))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            assert not t.is_alive(), "request thread hung"
        t = time.monotonic()
        out["hit"] = srv(hit_req)["token_ids"]
        out["e2e_s"][len(reqs)] = time.monotonic() - t
        return out

    def identity(self):
        """-> pid, runtime worker id, and the bytes torch has allocated on
        the card (0 before the engine touched it)."""
        import os
        import ray_tpu_torch as rt
        return {"pid": os.getpid(),
                "worker": rt.get_runtime_context().worker_id.hex(),
                "allocated": torch.cuda.memory_allocated()
                if torch.cuda.is_initialized() else 0}

    def say(self, text):
        """Print ``text`` in this process (its stdout is the runtime's)."""
        print(text, flush=True)
        return len(text)

    def forget_prefixes(self):
        """Drop every cached prefix page (none is in use between waves),
        so that phase 4's requests run again as on a fresh engine: -> the
        pages freed."""
        eng = self.srv.engine
        with self.srv._lock:
            return eng.prefix.evict(eng.prefix.num_cached)

    def one(self, prompt, max_tokens):
        """One request through ``__call__``: -> its tokens."""
        return self.srv({"prompt_ids": prompt,
                         "max_tokens": max_tokens})["token_ids"]

    def counts(self):
        return server_counts(self.srv)

    def tensors(self):
        """A bf16 and an fp32 tensor on the engine's device (and a strided
        view of the first), nested in a dict, beside their ``.cpu()``
        copies made here."""
        dev = self.srv.engine.device
        g = torch.Generator(device=dev).manual_seed(7)
        bf16 = torch.randn(2048, 4096, generator=g, device=dev).to(
            torch.bfloat16)
        f32 = torch.randn(1024, 1024, generator=g, device=dev)
        view = bf16.t()[::2]
        return {"device": {"nested": {"bf16": bf16}, "list": [f32, view]},
                "host": {"bf16": bf16.cpu(), "f32": f32.cpu(),
                         "view": view.cpu()}}


def server_counts(srv):
    """-> this process's launch counters, the ragged launches phase 4
    computes from the step counts of ``srv``'s engine, and its stats."""
    from ray_tpu_torch.ops import paged_attention as tpa
    eng = srv.engine
    stats = srv.stats()
    expected = eng.cfg.n_layers * (stats["ragged_dispatches"]
                                   + eng.decode_chunk
                                   * stats["decode_dispatches"])
    return dict(tpa.launch_counts), expected, stats


def check_streams(got, main_streams):
    """Every token stream of ``got`` equals phase 4's (when given)."""
    if main_streams is None:
        return
    for i, (toks, want) in enumerate(zip(got["wave"], main_streams["wave"])):
        assert toks == want, (i, toks, want)
    assert got["hit"] == main_streams["hit"], got["hit"]


def same_bytes(a, b):
    """Equal dtype, shape and bytes, ``b`` a CPU tensor."""
    return (b.device.type == "cpu" and a.dtype == b.dtype
            and a.shape == b.shape and torch.equal(
                a.contiguous().reshape(-1).view(torch.uint8),
                b.contiguous().reshape(-1).view(torch.uint8)))


def smi_compute_apps():
    """pid -> nvidia-smi's line for each compute process it lists."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    apps = {}
    for line in out.splitlines():
        head = line.split(",")[0].strip()
        if head.isdigit():
            apps[int(head)] = line.strip()
    return apps


def holds_cuda(pid):
    """Whether process ``pid`` has the NVIDIA driver's library mapped or a
    /dev/nvidia* device open: what a CUDA context needs (read from /proc,
    so it holds where nvidia-smi shows no process of this container)."""
    import os
    try:
        with open(f"/proc/{pid}/maps") as f:
            if "libcuda.so" in f.read():
                return True
        fd_dir = f"/proc/{pid}/fd"
        return any(os.readlink(os.path.join(fd_dir, fd)).startswith(
            "/dev/nvidia") for fd in os.listdir(fd_dir))
    except (FileNotFoundError, ProcessLookupError):
        return False


def wait_gone(pid, timeout=60.0):
    """Wait for process ``pid`` to end; -> the seconds it took."""
    import os
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return time.monotonic() - t0
        time.sleep(0.01)
    raise AssertionError(f"process {pid} still runs {timeout} s after kill")


def ppo_split(rl_case, device, runner_device):
    """PPO (``rl_case``: config, most iterations, gate) with the learner
    on ``device`` and its env runners sampling on ``runner_device``, in
    the runtime that is up, trained to its gate: -> the best mean, the
    iteration count, and the mean iteration split into sampling and the
    learner update (ms)."""
    config, iterations, gate = rl_case
    algo = dataclasses.replace(config, runner_device=runner_device).build(
        device=device)
    try:
        # the runners start (a process imports torch) before the first
        # timed iteration, as phase 11's threads do
        algo._broadcast_weights()
        best, results, it_ms = float("-inf"), [], []
        t0 = time.monotonic()
        for _ in range(iterations):
            t = time.monotonic()
            results.append(algo.train())
            it_ms.append((time.monotonic() - t) * 1e3)
            mean = results[-1]["episode_return_mean"]
            if mean == mean:
                best = max(best, mean)
            if best >= gate:
                break
        train_s = time.monotonic() - t0
    finally:
        algo.stop()
    n = len(results)
    return {"runners": len(algo.runners), "best": best, "iterations": n,
            "train_s": train_s, "it_ms": sum(it_ms) / n,
            "sample_ms": sum(r["time_sample_s"] for r in results) / n * 1e3,
            "learn_ms": sum(r["time_learn_s"] for r in results) / n * 1e3}


def node_cards(cuda, num_gpus):
    """The cards phases 14 and 15 tell their node of: ``num_gpus`` where
    given; else none, so that the node counts them, on a machine of one
    card, and one on a machine of several (their checks are of one card:
    a second lease waits for the card the first holds, the replica takes
    the node's only card)."""
    if cuda and num_gpus is None and torch.cuda.device_count() > 1:
        return 1
    return num_gpus


def phase_cluster(model_config=None, engine_config=None, main_streams=None,
                  num_gpus=None, big_bytes=BIG_TENSOR_BYTES,
                  rl_case=None, card="the CPU"):
    """The cluster runtime on the card: ``ray_tpu_torch.init()`` boots a
    head, a node daemon and the shm store as processes; phase 4's server
    runs in a GPU-leased worker, a second lease waits for the card,
    tensors cross processes, and PPO's runners run as processes.
    ``main_streams`` (phase 4's) must equal the worker's token streams;
    ``num_gpus`` tells the node its cards (``node_cards``). Returns a
    summary."""
    import os
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.worker import global_worker
    model_config = model_config or MAIN_MODEL
    engine_config = engine_config or MAIN_ENGINE
    cuda = engine_config.get("device", "cuda") == "cuda"
    t_phase = time.monotonic()
    reset_port_launch_counts()
    if cuda:
        # earlier phases' engines sit in reference cycles (a server and
        # its engine thread): collect them before the cache is emptied
        gc.collect()
        torch.cuda.empty_cache()
        log(f"cluster: the driver holds {torch.cuda.memory_reserved()} "
            f"bytes reserved, {torch.cuda.memory_allocated()} allocated, "
            f"at phase 14's start; {card}")
    shm = os.statvfs("/dev/shm")
    store = min(CLUSTER_STORE_BYTES, 3 * big_bytes)
    log(f"cluster: /dev/shm has {shm.f_bavail * shm.f_frsize} bytes free; "
        f"store arena {store} bytes")

    # 14a: boot
    t0 = time.monotonic()
    rt.init(num_cpus=CLUSTER_CPUS, num_gpus=node_cards(cuda, num_gpus),
            _system_config={"object_store_memory_bytes": store})
    boot_s = time.monotonic() - t0
    summary = {"boot_s": boot_s}
    try:
        backend = global_worker.backend
        daemons = {"head": backend._owned_procs[0].pid,
                   "node": backend._owned_procs[1].pid}
        res = rt.cluster_resources()
        log(f"cluster: boot {boot_s:.2f} s (head pid {daemons['head']}, "
            f"node pid {daemons['node']}), resources {res}")
        assert res.get("GPU") == 1.0, res
        for name, pid in daemons.items():
            assert not holds_cuda(pid), f"the {name} daemon holds CUDA"
        if cuda:
            # nvidia-smi may name processes by PIDs of another namespace
            # (a container's): printed, while holds_cuda reads /proc
            apps = smi_compute_apps()
            log(f"cluster: nvidia-smi's compute processes {apps}, the "
                f"driver's pid {os.getpid()}")
            assert not set(daemons.values()) & set(apps), apps
            free_before, total = torch.cuda.mem_get_info()

        # 14b: the main path in a GPU-leased worker
        server_cls = rt.remote(num_gpus=1)(MainServer)
        t_submit = time.time()
        a = server_cls.remote(model_config, engine_config)
        where = rt.get(a.where.remote(), timeout=600)
        create_s = time.time() - t_submit
        dev = rt.get(a.device.remote(), timeout=60)
        log(f"cluster: the server actor's creation {create_s:.2f} s (lease "
            f"and spawn {where['t_start'] - t_submit:.2f} s, the worker's "
            f"start-up, its imports and the class "
            f"{where['t_enter'] - where['t_start']:.2f} s, the server's "
            f"construction {where['build_s']:.2f} s); worker pid "
            f"{where['pid']}, CUDA_VISIBLE_DEVICES {where['visible']!r}, "
            f"device {dev}")
        assert where["visible"] == "0", where
        assert where["pid"] not in (os.getpid(), *daemons.values())
        if cuda:
            assert dev["count"] == 1 and dev["name"] == \
                torch.cuda.get_device_name(0), dev
            assert holds_cuda(where["pid"])
        got = rt.get(a.answer.remote(), timeout=900)
        launches, expected, stats = rt.get(a.counts.remote(), timeout=60)
        mem = rt.get(a.device.remote(), timeout=60)
        n_req = len(got["wave"])
        for i in sorted(got["e2e_s"]):
            theirs = main_streams["e2e_s"].get(i) if main_streams else None
            log(f"cluster: request {i}: {got['e2e_s'][i] * 1e3:.1f} ms in "
                f"the worker" + ("" if theirs is None else
                                 f", {theirs * 1e3:.1f} ms in phase 4"))
        check_streams(got, main_streams)
        log(f"cluster: the worker's {n_req + 1} token streams "
            + ("equal phase 4's" if main_streams is not None else
               "(no phase 4 run to compare)")
            + f"; worker launches {launches}, expected ragged "
            f"{expected}; engine stats {json.dumps(stats)}")
        if cuda:
            assert launches["ragged_paged_attention"] == expected, \
                (launches, expected)
            apps = smi_compute_apps()
            log(f"cluster: the worker's peak allocated "
                f"{mem['peak_allocated']} bytes, reserved {mem['reserved']};"
                f" nvidia-smi's line for its pid: "
                f"{apps.get(where['pid'], 'none')} (all: {apps})")
        else:
            assert not any(launches.values()), launches
        assert launches["ragged_paged_attention_reference_cuda"] == 0, \
            "the plain attention ran on CUDA tensors in the worker"
        driver = port_launch_counts()
        assert not any(driver.values()), driver
        summary.update(launches=launches, expected=expected,
                       create_s=create_s)

        # 14d (while the server holds the card): tensors across processes
        out = rt.get(a.tensors.remote(), timeout=120)
        pairs = [(out["host"]["bf16"], out["device"]["nested"]["bf16"]),
                 (out["host"]["f32"], out["device"]["list"][0]),
                 (out["host"]["view"], out["device"]["list"][1])]
        for host, arrived in pairs:
            assert same_bytes(host, arrived), (host.dtype, host.shape)
        big = torch.arange(big_bytes // 4, dtype=torch.float32)
        t0 = time.monotonic()
        ref = rt.put(big)
        put_s = time.monotonic() - t0
        assert backend.object_plane.store.contains(ref.id().binary())
        t0 = time.monotonic()
        back = rt.get(ref, timeout=120)
        get_s = time.monotonic() - t0
        assert same_bytes(big, back)

        @rt.remote(num_cpus=1)
        def read_big(refs):
            t = time.monotonic()
            x = rt.get(refs[0], timeout=120)
            t_get = time.monotonic() - t
            total = float(x.sum(dtype=torch.float64))
            return t_get, time.monotonic() - t - t_get, total

        w_get, w_sum, w_total = rt.get(read_big.remote([ref]), timeout=300)
        assert w_total == float(big.sum(dtype=torch.float64)), w_total
        # the same put again once the first object has left the store
        store_key = ref.id().binary()
        del back, ref
        t0 = time.monotonic()
        while backend.object_plane.store.contains(store_key):
            assert time.monotonic() - t0 < 60, "the freed object stays"
            time.sleep(0.01)
        t0 = time.monotonic()
        ref = rt.put(big)
        put2_s = time.monotonic() - t0
        del ref
        log(f"cluster: tensors from the worker's device arrive as CPU "
            f"tensors equal byte for byte to its .cpu() ({[tuple(h.shape) for h, _ in pairs]}, "
            f"bf16, fp32 and a strided bf16 view); put of a {big_bytes}-byte "
            f"CPU tensor {put_s * 1e3:.1f} ms ({big_bytes / put_s / 1e9:.2f} "
            f"GB/s), the same put once the first was freed "
            f"{put2_s * 1e3:.1f} ms ({big_bytes / put2_s / 1e9:.2f} GB/s), "
            f"get {get_s * 1e3:.2f} ms (a view of the store); in a "
            f"CPU worker get {w_get * 1e3:.2f} ms, a sum over it "
            f"{w_sum * 1e3:.1f} ms ({big_bytes / w_sum / 1e9:.2f} GB/s); "
            f"{card}")
        summary.update(put_gbps=big_bytes / put_s,
                       put2_gbps=big_bytes / put2_s)
        del big

        # 14c: leases
        b = server_cls.remote(model_config, engine_config, build=False)
        pending = b.where.remote()
        ready, _ = rt.wait([pending], timeout=2)
        assert ready == [], "a second num_gpus=1 lease placed on a held card"
        t0 = time.monotonic()
        rt.kill(a)
        gone_s = wait_gone(where["pid"])
        if cuda:
            free_after, _ = torch.cuda.mem_get_info()
            apps = smi_compute_apps()
            assert where["pid"] not in apps, apps
        b_where = rt.get(pending, timeout=300)
        wait_s = time.monotonic() - t0
        log(f"cluster: the second lease waited while the first held the "
            f"card; kill -> the worker process gone in {gone_s:.2f} s, the "
            f"second lease placed {wait_s:.2f} s after the kill (pid "
            f"{b_where['pid']}, CUDA_VISIBLE_DEVICES "
            f"{b_where['visible']!r})" + (
                f"; free device memory {free_before} bytes before the first "
                f"worker, {free_after} after its end (of {total})"
                if cuda else ""))
        assert b_where["visible"] == "0" and b_where["pid"] != where["pid"]
        if cuda:
            assert free_after >= free_before - MEMORY_RETURN_SLACK, \
                (free_before, free_after)
        rt.get(b.build.remote(), timeout=600)
        got_b = rt.get(b.answer.remote(), timeout=900)
        launches_b, expected_b, _ = rt.get(b.counts.remote(), timeout=60)
        check_streams(got_b, main_streams)
        log(f"cluster: the second worker answered phase 4's requests in "
            f"{sum(got_b['e2e_s'].values()) * 1e3:.1f} ms of request wall "
            f"time: its {len(got_b['wave']) + 1} token streams "
            + ("equal phase 4's" if main_streams is not None else
               "(no phase 4 run to compare)")
            + f"; ragged launches {launches_b['ragged_paged_attention']}, "
            f"expected {expected_b}")
        if cuda:
            assert launches_b["ragged_paged_attention"] == expected_b, \
                (launches_b, expected_b)
        assert launches_b["ragged_paged_attention_reference_cuda"] == 0
        rt.kill(b)
        summary.update(lease_wait_s=wait_s)

        # 14e: PPO with its env runners as worker processes
        if rl_case is None:
            rl_case = rl_cases()["PPO"]
        learner = "cuda" if cuda else "cpu"
        # the runners sample on their CPUs: the gated run
        runs = {("processes", "cpu"): ppo_split(rl_case, learner, "cpu")}
        if cuda:
            runs["processes", "cuda"] = ppo_split(rl_case, learner, "cuda")
    finally:
        rt.shutdown()
    # the same PPO with thread runners (local mode) on each device, so
    # that processes and devices are each changed alone
    rt.init(local_mode=True, num_cpus=CLUSTER_CPUS)
    try:
        for runner in (("cpu", "cuda") if cuda else ("cpu",)):
            runs["threads", runner] = ppo_split(rl_case, learner, runner)
    finally:
        rt.shutdown()
    threads = RL_SPLITS.get("PPO")
    for (kind, runner), r in runs.items():
        log(f"cluster: PPO with {r['runners']} env runners as {kind} "
            f"sampling on {runner}, the learner on {learner}: best mean "
            f"{r['best']:.2f} after {r['iterations']} iterations (gate "
            f"{rl_case[2]}), {r['train_s']:.2f} s; iteration ms "
            f"{r['it_ms']:.2f} (sampling {r['sample_ms']:.2f}, learner "
            f"update {r['learn_ms']:.2f}); {card}")
    if threads is not None:
        log(f"cluster: phase 11's PPO (thread runners on the card): "
            f"iteration {threads[0]:.2f} ms (sampling {threads[1]:.2f}, "
            f"update {threads[2]:.2f}); {card}")
    gated = runs["processes", "cpu"]
    assert gated["best"] >= rl_case[2], f"PPO failed to learn: {gated}"
    summary.update(ppo_iterations=gated["iterations"],
                   ppo_sample_ms=gated["sample_ms"],
                   ppo_learn_ms=gated["learn_ms"],
                   ppo_runs=runs)
    log(f"phase 14: {time.monotonic() - t_phase:.1f} s")
    return summary


#: phase 15's deployment name and the most requests its replica runs at
#: once (the hold and phase 4's first wave, with room to spare)
SERVE_NAME = "llm8b"
SERVE_MAX_ONGOING = 8
#: the shm arena of phase 15's cluster (no large object crosses it)
SERVE_STORE_BYTES = 256 << 20
SERVE_CHAT = [{"role": "system", "content": "you are an 8B model"},
              {"role": "user", "content": "say something"}]
SERVE_CHAT_TOKENS = 8


def serve_server_class():
    """Phase 15's deployment body: phase 4's ``LLMServer`` with what the
    smoke reads through the handle — ``hold(n)`` (the next engine step
    waits for ``n`` requests, as phase 4's wave is admitted), ``counts()``
    (this process's launch counters, counted from 0 after construction,
    beside the engine's ragged count) and ``where()`` (the process and
    its ``CUDA_VISIBLE_DEVICES``)."""
    from ray_tpu_torch.llm.serve_llm import LLMServer

    class ServeServer(LLMServer):
        def __init__(self, model_config, engine_config):
            import os
            from ray_tpu_torch.ops import paged_attention as tpa
            self.t_enter = time.time()
            self.pid = os.getpid()
            t0 = time.monotonic()
            super().__init__(model_config, engine_config)
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize()
            self.build_s = time.monotonic() - t0
            for name in tpa.launch_counts:
                tpa.launch_counts[name] = 0

        def hold(self, n):
            admit_together(self.engine, n)

        def counts(self):
            return server_counts(self)

        def where(self):
            import os
            return {"pid": self.pid, "t_enter": self.t_enter,
                    "build_s": self.build_s,
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "vocab": self.engine.cfg.vocab_size,
                    "prefill_chunk": self.engine.prefill_chunk}

    return ServeServer


def sse_frames(resp):
    """The data: frames of a streaming HTTP response, as they arrive."""
    buf = b""
    while True:
        chunk = resp.read1(65536)
        if not chunk:
            return
        buf += chunk
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            for line in frame.splitlines():
                if line.startswith(b"data: "):
                    yield line[len(b"data: "):].decode()


def post_json(port, path, body, timeout=600):
    import urllib.request
    return urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}), timeout=timeout)


def phase_serve(model_config=None, engine_config=None, main_streams=None,
                num_gpus=None, card="the CPU"):
    """Serve on the card: phase 4's server deployed through ``serve.run``
    in a replica holding the card, phase 4's first wave through the
    handle and its prefix hit through the HTTP proxy (streams equal to
    ``main_streams``, phase 4's, when given), the replica's launches, the
    request records at the head, and the teardown. ``num_gpus`` tells the
    node its cards (``node_cards``). Returns a summary."""
    import os
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.llm.serve_llm import apply_chat_template, build_llm_app
    from ray_tpu_torch.util import trace_context
    model_config = model_config or MAIN_MODEL
    engine_config = engine_config or MAIN_ENGINE
    cuda = engine_config.get("device", "cuda") == "cuda"
    t_phase = time.monotonic()
    reset_port_launch_counts()
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    rt.init(num_cpus=CLUSTER_CPUS, num_gpus=node_cards(cuda, num_gpus),
            _system_config={"object_store_memory_bytes": SERVE_STORE_BYTES,
                            "metrics_export_period_s": 1.0})
    summary = {}
    try:
        assert rt.cluster_resources().get("GPU") == 1.0, \
            rt.cluster_resources()
        if cuda:
            free_before, total = torch.cuda.mem_get_info()

        # 15a: deploy with the resources build_llm_app derives for this
        # model and engine on the card
        on_card = {k: v for k, v in engine_config.items() if k != "device"}
        resources = build_llm_app(model_config, on_card).deployment \
            ._config["resources"]
        assert resources == {"GPU": 1.0}, resources
        dep = serve.deployment(
            name=SERVE_NAME, max_ongoing_requests=SERVE_MAX_ONGOING,
            ray_actor_options={"resources": resources})(serve_server_class())
        t_submit = time.time()
        t0 = time.monotonic()
        h = serve.run(dep.bind(model_config, engine_config), timeout_s=900)
        deploy_s = time.monotonic() - t0
        where = h.where.remote().result(timeout=60)
        avail = rt.available_resources()
        log(f"serve: deployed {SERVE_NAME} in {deploy_s:.2f} s (from "
            f"serve.run to the replica's __init__, the controller's start, "
            f"the lease and the worker's start-up and imports, "
            f"{where['t_enter'] - t_submit:.2f} s; the server's "
            f"construction {where['build_s']:.2f} s); replica pid "
            f"{where['pid']}, CUDA_VISIBLE_DEVICES {where['visible']!r}, "
            f"resources {resources}, the node's GPU left "
            f"{avail.get('GPU', 0.0)}")
        assert where["visible"] == "0", where
        assert avail.get("GPU", 0.0) == 0.0, avail
        assert where["pid"] != os.getpid()
        if cuda:
            assert holds_cuda(where["pid"])

        # 15b: phase 4's first wave through the handle, one thread and
        # one trace each, admitted at one engine step
        reqs, hit_req = main_requests(where["vocab"], where["prefill_chunk"])
        wave = [None] * len(reqs)
        e2e, rids, traces = {}, {}, {}

        def run(i, kind, prompt, max_tokens):
            tid = trace_context.new_trace_id()
            ctx = trace_context.activate(tid, trace_context.new_span_id())
            try:
                t = time.monotonic()
                body = {"prompt_ids": prompt, "max_tokens": max_tokens}
                if kind == "call":
                    out = h.remote(body).result(timeout=900)
                    toks, rid = out["token_ids"], out["request_id"]
                else:
                    toks = []
                    for item in h.stream.options(stream=True).remote(body):
                        rid = item["request_id"]
                        if item.get("done"):
                            assert item["token_ids"] == toks
                            break
                        toks += item["token_ids"]
                e2e[i] = time.monotonic() - t
                wave[i], rids[i], traces[i] = toks, rid, tid
            finally:
                trace_context.deactivate(ctx)

        h.hold.remote(len(reqs)).result(timeout=60)
        threads = [threading.Thread(target=run, args=(i, *r))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
            assert not t.is_alive(), "request thread hung"
        for i, toks in enumerate(wave):
            assert toks is not None and len(toks) == reqs[i][2], (i, toks)

        # 15c: the prefix hit alone through the HTTP proxy, streamed
        port = serve.start_http_proxy()
        t = time.monotonic()
        with post_json(port, "/v1/completions",
                       {"model": SERVE_NAME, "stream": True,
                        **hit_req}) as resp:
            assert resp.headers["Content-Type"].startswith(
                "text/event-stream")
            frames = list(sse_frames(resp))
        e2e[len(reqs)] = time.monotonic() - t
        assert frames[-1] == "[DONE]", frames[-3:]
        chunks = [json.loads(f) for f in frames[:-1]]
        assert all(c["object"] == "text_completion.chunk" for c in chunks)
        hit = [tok for c in chunks for tok in c["choices"][0]["token_ids"]]
        rids[len(reqs)] = chunks[0]["id"][len("cmpl-"):]
        assert chunks[-1]["choices"][0]["finish_reason"] == "length"
        assert chunks[-1]["usage"]["completion_tokens"] == len(hit)
        check_streams({"wave": wave, "hit": hit}, main_streams)
        t = time.monotonic()
        with post_json(port, "/v1/chat/completions",
                       {"model": SERVE_NAME, "messages": SERVE_CHAT,
                        "max_tokens": SERVE_CHAT_TOKENS}) as resp:
            chat = json.loads(resp.read())
        chat_s = time.monotonic() - t
        n_prompt = len(apply_chat_template(SERVE_CHAT).encode())
        assert chat["object"] == "chat.completion", chat
        assert chat["choices"][0]["message"]["role"] == "assistant"
        assert chat["choices"][0]["finish_reason"] == "length", chat
        assert chat["usage"] == {
            "prompt_tokens": n_prompt,
            "completion_tokens": SERVE_CHAT_TOKENS,
            "total_tokens": n_prompt + SERVE_CHAT_TOKENS,
            "prompt_tokens_details": {"cached_tokens": 0}}, chat["usage"]
        rids["chat"] = chat["id"][len("chatcmpl-"):]
        for i in sorted(e2e):
            theirs = main_streams["e2e_s"].get(i) if main_streams else None
            how = "HTTP" if i == len(reqs) else "the handle"
            log(f"serve: request {i} through {how}: "
                f"{e2e[i] * 1e3:.1f} ms" + ("" if theirs is None else
                                            f", {theirs * 1e3:.1f} ms in "
                                            f"phase 4"))
        log(f"serve: chat completion through HTTP: {chat_s * 1e3:.1f} ms, "
            f"usage {chat['usage']}")
        log(f"serve: the replica's {len(reqs) + 1} token streams "
            + ("equal phase 4's" if main_streams is not None else
               "(no phase 4 run to compare)"))

        # 15d: the replica's launches, and the records at the head
        launches, expected, stats = h.counts.remote().result(timeout=60)
        log(f"serve: replica launches {launches}, expected ragged "
            f"{expected}; engine stats {json.dumps(stats)}")
        if cuda:
            assert launches["ragged_paged_attention"] == expected, \
                (launches, expected)
        else:
            assert not any(launches.values()), launches
        assert launches["ragged_paged_attention_reference_cuda"] == 0, \
            "the plain attention ran on CUDA tensors in the replica"
        assert not any(port_launch_counts().values())
        head = global_worker.backend.head
        t0 = time.monotonic()
        records = {}
        while len(records) < len(rids):
            assert time.monotonic() - t0 < 60, \
                f"records never reached the head: {sorted(records)}"
            for key, rid in rids.items():
                got = head.call("requests_dump", {"request": rid},
                                timeout=10)
                if got and got[0].get("done"):
                    records[key] = got[0]
            time.sleep(0.2)
        records_s = time.monotonic() - t0
        for key, rec in records.items():
            assert rec["worker"] and rec["node"], rec
            if key in traces:
                assert rec["trace_id"] == traces[key], (key, rec)
            else:
                assert rec["trace_id"], rec       # the proxy's own trace
        log(f"serve: {len(records)} finished records at the head "
            f"{records_s:.2f} s after the last request, the handle's with "
            f"their callers' trace ids; worker "
            f"{records[0]['worker']}, node {records[0]['node']}")
        summary.update(launches=launches, expected=expected,
                       deploy_s=deploy_s, e2e_s=e2e)

        # 15e: teardown
        serve.delete(SERVE_NAME)
        serve.shutdown()
        gone_s = wait_gone(where["pid"])
        if cuda:
            free_after, _ = torch.cuda.mem_get_info()
            log(f"serve: the replica's process gone {gone_s:.2f} s after "
                f"the teardown; free device memory {free_before} bytes "
                f"before the deployment, {free_after} after (of {total})")
            assert free_after >= free_before - MEMORY_RETURN_SLACK, \
                (free_before, free_after)
    finally:
        rt.shutdown()
    log(f"phase 15: {time.monotonic() - t_phase:.1f} s; {card}")
    return summary


# ------------------------------------------------------------------ main


# ------------------------- phase 16: the mesh and distributed training

#: the flash kernels' shard shapes on the bench config (B 8, 24 q / 12 kv
#: heads, L 2048, D 128): name -> (B, q heads, kv heads) of one rank
FLASH_SHARDS = {"dp 2": (4, 24, 12), "tp 2": (8, 12, 6), "tp 4": (8, 6, 3)}
#: the cluster phase 16 boots (no large object crosses its store)
TRAINER_CPUS = 4
TRAINER_STORE_BYTES = 256 << 20
#: 16c: phase 7's widths at 1 of its 8 layers, a checkpoint every step,
#: the worker's exit after this many steps, and the steps in all (the
#: depth kept low: the whole script must stay well inside its time limit)
RESTART_CONFIG = dict(TRAIN_CONFIG, n_layers=1)
RESTART_KILL_AT, RESTART_STEPS = 1, 3
TRAINER_LOSS_RTOL = 1e-5
RESTART_LOSS_RTOL = 1e-6


def phase_flash_shards(device, full=None, shards=None, L=2048, D=128):
    """16a: the three flash kernels at one rank's shard of the bench
    config (``FLASH_SHARDS``: batch over dp, heads over tp, GQA's kv heads
    repeated to the shard's q heads as the model does), each against its
    plain version with phase 6's limits, a planted causal fault that must
    fail on every query tile, and the kernels' times beside phase 6's at
    the whole shape (``full``: phase 6's record)."""
    from ray_tpu_torch.ops import flash_attention as tfa
    out = {}
    for name, (B, Hq, Hkv) in (shards or FLASH_SHARDS).items():
        g = torch.Generator(device=device).manual_seed(16)
        q, do = (torch.randn(B, L, Hq, D, generator=g, device=device)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(B, L, Hkv, D, generator=g, device=device)
                .bfloat16().repeat_interleave(Hq // Hkv, dim=2)
                for _ in range(2))
        tfa.check_shard_geometry(q, k, v)
        qb, kb, vb, dob = (tfa._bhl(t) for t in (q, k, v, do))
        BH, scale = B * Hq, D ** -0.5
        o, lse = tfa._fwd_call(qb, kb, vb, True, scale)
        o_ref, lse_ref = tfa._fwd_reference(qb, kb, vb, True, scale)
        delta = (dob.float() * o_ref.float()).sum(-1)
        grads = tfa._bwd_call(qb, kb, vb, o_ref, lse_ref, dob, True, scale)
        grads_ref = tfa._bwd_reference(qb, kb, vb, lse_ref, dob, delta,
                                       True, scale)
        ratios = {}
        for label, got, want in zip(("o", "dq", "dk", "dv"),
                                    (o, *grads), (o_ref, *grads_ref)):
            assert torch.isfinite(got).all(), f"{name}: {label} not finite"
            ratios[label] = flash_ratios(got, want).max().item()
            assert ratios[label] <= 1, f"{name}: {label} at {ratios[label]}"
        lse_err = (lse - lse_ref).abs().max().item()
        assert lse_err <= LSE_ATOL, f"{name}: lse off by {lse_err}"
        caught = tiles_caught(causal_off_by_one(qb, kb, vb, scale)[0], o_ref)
        assert bool((caught > 1).all()), f"{name}: fault not caught {caught}"
        tiles = tfa.default_tiles(qb.dtype, D)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        dq, dk, dv = (torch.empty_like(qb) for _ in range(3))
        ms = {"flash_attention_fwd": time_ms(
                  lambda: tfa._fwd_cuda(qb, kb, vb, True, scale),
                  flush=flush),
              "flash_attention_dq": time_ms(lambda: tfa._launch_dq(
                  qb, kb, vb, dob, lse_ref, delta, dq, True, scale,
                  tiles.dq), flush=flush),
              "flash_attention_dkv": time_ms(lambda: tfa._launch_dkv(
                  qb, kb, vb, dob, lse_ref, delta, dk, dv, True, scale,
                  tiles.dkv), flush=flush)}
        del flush
        out[name] = {"ratios": ratios, "ms": ms}
        whole = "" if full is None else ", phase 6's whole shape (B 8 H 24) " \
            + ", ".join(f"{full[k]['ms']:.4f}" for k in ms)
        log(f"flash per shard, {name} (B {B}, {Hq} q heads over {Hkv} kv, "
            f"L {L}, D {D}, bf16, causal): worst ratio to the limit "
            + ", ".join(f"{k} {r:.3f}" for k, r in ratios.items())
            + f"; planted fault fails on all {caught.numel()} query tiles "
            f"(weakest {caught.min().item():.1f} x); kernel ms fwd, dq, dkv "
            + ", ".join(f"{x:.4f}" for x in ms.values()) + whole)
    return out


def trainer_loop(cfg):
    """The rank program of 16b and 16c, run by ``TorchTrainer`` in a
    GPU-leased worker: phase 7's model and batch from its seeds, sharded
    by ``param_specs`` on the run's mesh, Adafactor, ``cfg["steps"]``
    steps; with ``cfg["marker"]`` a checkpoint (parameters and optimizer
    state) at every step, a restore when the run restarts, and the
    worker's exit after ``cfg["kill_at"]`` steps the first time."""
    import functools
    import os
    import time

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.train import Adafactor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cfg.get("threads"):
        # on the CPU the sums' order follows the thread count: take the
        # calling process's, so that the two runs sum alike
        torch.set_num_threads(cfg["threads"])
    ctx = train.get_context()
    device = torch.device(cfg["device"])
    cuda = device.type == "cuda"
    free_at_start = torch.cuda.mem_get_info()[0] if cuda else 0
    mesh = ctx.global_mesh()
    mcfg = tl.LlamaConfig(**cfg["model"])
    params = train.shard_params(tl.init_params(mcfg, seed=0, device=device),
                                mesh, tl.param_specs(mcfg))
    g = torch.Generator(device=device).manual_seed(1)
    tokens = train.shard_batch(torch.randint(
        0, mcfg.vocab_size, tuple(cfg["batch"]), generator=g, device=device),
        mesh)
    init_fn, step_fn = train.make_train_step(
        functools.partial(tl.loss_fn, cfg=mcfg, mesh=mesh),
        functools.partial(Adafactor, lr=cfg["lr"]))
    opt = init_fn(params)
    load_s = None
    if ctx.get_checkpoint() is not None:
        t0 = time.monotonic()
        state = ctx.get_checkpoint().load(target={"params": params,
                                                  "opt": None})
        with torch.no_grad():
            for dst, src in zip(train.param_leaves(params),
                                train.param_leaves(state["params"])):
                dst.to_local().copy_(src.to_local())
        opt.load_state_dict(state["opt"])     # this rank's slices
        load_s = time.monotonic() - t0
    for name in tfa.launch_counts:
        tfa.launch_counts[name] = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    save_s = []
    while ctx.step < cfg["steps"]:
        if cfg.get("marker") and ctx.step == cfg["kill_at"] \
                and not os.path.exists(cfg["marker"]):
            with open(cfg["marker"], "w") as f:
                f.write(str(free_at_start))
            os._exit(1)
        t0 = time.monotonic()
        params, opt, m = step_fn(params, opt, tokens)
        loss = float(m["loss"])            # waits for the card
        step_s = time.monotonic() - t0
        ckpt = {"params": params, "opt": opt.state_dict()} \
            if cfg.get("marker") else None
        t0 = time.monotonic()
        train.report({"loss": loss, "step_s": step_s,
                      "launches": dict(tfa.launch_counts),
                      "peak": torch.cuda.max_memory_allocated() if cuda
                      else 0, "free_at_start": free_at_start,
                      "pid": os.getpid(), "load_s": load_s,
                      "save_s": list(save_s),
                      "world": mesh.size(), "backend":
                      torch.distributed.get_backend()},
                     checkpoint_tree=ckpt)
        if ckpt is not None:
            save_s.append(time.monotonic() - t0)


def run_trainer(device, model, batch, steps, storage, name, marker=None,
                kill_at=None, lr=1e-3):
    """``TorchTrainer`` over one GPU-leased worker (a CPU worker on the
    CPU), ``MeshSpec(fsdp=-1)``: -> the Result."""
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel.mesh import MeshSpec
    cuda = device.type == "cuda"
    run = train.RunConfig(
        name=name, storage_path=str(storage),
        failure_config=train.FailureConfig(max_failures=1 if marker else 0),
        checkpoint_config=train.CheckpointConfig(num_to_keep=2))
    return train.TorchTrainer(
        trainer_loop,
        train_loop_config={"device": device.type, "model": model,
                           "batch": batch, "steps": steps, "lr": lr,
                           "marker": marker, "kill_at": kill_at,
                           "threads": None if cuda else
                           torch.get_num_threads()},
        scaling_config=train.ScalingConfig(
            num_workers=1, use_gpu=cuda, mesh=MeshSpec(fsdp=-1)),
        run_config=run).fit()


def uninterrupted_losses(device, model, batch, steps, lr=1e-3):
    """The same steps as ``trainer_loop`` run in this process without a
    mesh: the uninterrupted run."""
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.train import Adafactor, make_train_step
    cfg = LlamaConfig(**model)
    params = init_params(cfg, seed=0, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, tuple(batch), generator=g,
                           device=device)
    init_fn, step_fn = make_train_step(
        functools.partial(loss_fn, cfg=cfg),
        functools.partial(Adafactor, lr=lr))
    opt = init_fn(params)
    losses = []
    for _ in range(steps):
        params, opt, m = step_fn(params, opt, tokens)
        losses.append(float(m["loss"]))
    return losses


def phase_trainer(device, config=None, batch=TRAIN_BATCH,
                  steps=TRAIN_WARMUP + TRAIN_STEPS, restart_config=None,
                  restart_batch=TRAIN_BATCH, card="the CPU"):
    """16b and 16c on a fresh cluster: ``TorchTrainer`` with one worker
    that leases the card and joins an NCCL group of world size 1 (gloo on
    the CPU). 16b: phase 7's run through the trainer; its losses must
    equal phase 7's (``TRAIN_RUNS``, rel ``TRAINER_LOSS_RTOL``) and its
    flash launches the path's count. 16c: 1 layer, a checkpoint each
    step, the worker's exit after ``RESTART_KILL_AT`` steps, the restart
    from the last checkpoint; the losses after it must equal an
    uninterrupted run's (rel ``RESTART_LOSS_RTOL``) and the card's free
    memory must come back to the byte. Returns 16b's worker launches."""
    import os
    import tempfile
    import ray_tpu_torch as rt
    from ray_tpu_torch.models.llama import LlamaConfig, flops_per_token
    config = config or TRAIN_CONFIG
    restart_config = restart_config or RESTART_CONFIG
    cuda = device.type == "cuda"
    t_phase = time.monotonic()
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    storage = Path(tempfile.mkdtemp(prefix="phase16-"))
    rt.init(num_cpus=TRAINER_CPUS, num_gpus=1 if cuda else None,
            _system_config={"object_store_memory_bytes":
                            TRAINER_STORE_BYTES})
    try:
        # 16b: phase 7 through the trainer
        t0 = time.monotonic()
        result = run_trainer(device, config, batch, steps, storage, "16b")
        fit_s = time.monotonic() - t0
        hist = result.metrics_history
        last = hist[-1]
        losses = [m["loss"] for m in hist]
        assert last["backend"] == ("nccl" if cuda else "gloo") \
            and last["world"] == 1, last
        ref = TRAIN_RUNS.get("adafactor")
        gap = None
        if ref is not None:
            assert len(ref["losses"]) == len(losses), (ref, losses)
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, ref["losses"]))
            assert gap <= TRAINER_LOSS_RTOL, (losses, ref["losses"])
        launches = last["launches"]
        cfg = LlamaConfig(**config)
        expected = expected_flash_launches(cfg.n_layers, steps) if cuda \
            else dict.fromkeys(expected_flash_launches(0, 0), 0)
        assert launches == expected, (launches, expected)
        B, L = batch
        timed = [m["step_s"] for m in hist[TRAIN_WARMUP:]] or \
            [m["step_s"] for m in hist]
        step_s = sum(timed) / len(timed)
        tok_s = B * L / step_s
        mfu = tok_s * flops_per_token(cfg, L) / BF16_FLOPS
        if cuda:
            wait_gone(last["pid"])
        log(f"trainer: TorchTrainer, 1 worker (pid {last['pid']}), "
            f"{last['backend']} group of {last['world']}, fit {fit_s:.1f} s; "
            f"losses {[round(x, 4) for x in losses]}"
            + ("" if gap is None else
               f", largest gap to phase 7's {gap:.2e} of itself")
            + f"; flash launches {launches} (expected {expected})")
        line = (f"trainer: step {step_s * 1e3:.1f} ms (mean of "
                f"{len(timed)} after {len(hist) - len(timed)} warm-up), "
                f"{tok_s:.0f} tokens/s, MFU {mfu:.1%}, peak memory "
                f"{last['peak']} bytes")
        if ref is not None:
            line += (f"; phase 7 in this process: step "
                     f"{ref['step_s'] * 1e3:.1f} ms, {ref['tok_s']:.0f} "
                     f"tokens/s, MFU {ref['mfu']:.1%}, peak memory "
                     f"{ref['peak']} bytes")
        log(line + f"; {card}")

        # 16c: restart from a sharded checkpoint
        want = uninterrupted_losses(device, restart_config, restart_batch,
                             RESTART_STEPS)
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            free_before = torch.cuda.mem_get_info()[0]
        marker = storage / "16c-exited"
        t0 = time.monotonic()
        result = run_trainer(device, restart_config, restart_batch,
                             RESTART_STEPS, storage, "16c",
                             marker=str(marker), kill_at=RESTART_KILL_AT)
        fit_s = time.monotonic() - t0
        assert marker.exists(), "the worker never exited"
        hist = result.metrics_history
        got = [m["loss"] for m in hist]
        assert [m["_step"] for m in hist] == list(
            range(RESTART_KILL_AT + 1, RESTART_STEPS + 1)), hist
        gaps = [abs(a - b) / abs(b)
                for a, b in zip(got, want[RESTART_KILL_AT:])]
        assert max(gaps) <= RESTART_LOSS_RTOL, (got, want)
        last = hist[-1]
        first_free = int(marker.read_text())
        ckpt = Path(result.checkpoint.path)
        files = sorted(f.name for f in ckpt.iterdir())
        nbytes = sum((ckpt / f).stat().st_size for f in files)
        mem = ""
        if cuda:
            wait_gone(last["pid"])
            free_after = torch.cuda.mem_get_info()[0]
            # the exited worker's memory came back: the card's free
            # memory after the run is, to the byte, this process's view
            # before it (each worker's view at its start is printed only:
            # a context's own footprint may differ between two starts)
            assert free_after == free_before, (free_before, free_after)
            mem = (f"; free device memory in this process's view "
                   f"{free_before} bytes before the run and {free_after} "
                   f"after; at each worker's start (printed only) "
                   f"{first_free} and {last['free_at_start']}")
        log(f"trainer restart: {restart_config['n_layers']} layers, the "
            f"worker exited after step {RESTART_KILL_AT}, the run resumed "
            f"from checkpoint_{RESTART_KILL_AT:08d} and finished in "
            f"{fit_s:.1f} s; losses after the restart {got} against the "
            f"uninterrupted run's {want[RESTART_KILL_AT:]} (largest gap "
            f"{max(gaps):.1e} of itself); the last checkpoint's files "
            f"{files}, {nbytes} bytes; the restarted worker read its "
            f"checkpoint in {last['load_s']:.2f} s and wrote step "
            f"{RESTART_KILL_AT + 1}'s in {last['save_s'][0]:.2f} s "
            f"(report with the checkpoint, sync save)" + mem)
    finally:
        rt.shutdown()
    log(f"phase 16b, 16c: {time.monotonic() - t_phase:.1f} s; {card}")
    return launches



# ------------------------------- phase 17: the parallel axes left

#: 17a: the tensor-parallel engine's shards, both on the one card
TP_DEVICES = ("cuda:0", "cuda:0")
#: the ragged kernel's per-shard geometry at 8B widths: tp -> (Hq, Hkv)
TP_SHARD_GEOMETRY = {2: {"Hq": 16, "Hkv": 4, "D": 128, "ps": 16},
                     4: {"Hq": 8, "Hkv": 2, "D": 128, "ps": 16}}
#: 17b: 8B widths at 2 of their 32 layers, over 4 shards
TP4_MODEL = dict(MAIN_MODEL, n_layers=2)
#: below this top-2 logit margin a bf16 stream may part from phase 4's
#: (the split sums round each shard's partial product before adding);
#: besides it, a margin under twice the logits' bf16 noise at that step
#: (the bf16 forward's largest distance from the fp32 forward)
TP_MARGIN_FLOOR = 2.0 ** -5
#: 17a: the peak over what the tp engine holds (every shard's weights and
#: pool), at most: the steps' activations and one matrix drawn at set-up
#: (phase 4 peaked 0.16 GB over its weights and pool, PERF.md)
TP_PEAK_SLACK = 1 << 30
#: 17c: one rank's block (B, heads, block length, head dim) and the ring
#: sizes; phase 6's limits (FLASH_RTOL per row, LSE_ATOL)
RING_SHARD = (1, 24, 2048, 128)
RING_DEGREES = (2, 4)


def ring_blocks(sp):
    """Flash blocks one causal ring pass over ``sp`` ranks runs: rank idx
    attends its diagonal block and the idx earlier ones."""
    return sp * (sp + 1) // 2


def held_bytes(*trees):
    """The bytes of the distinct storages under ``trees`` (nested dicts
    and lists of tensors): a tensor shared by shards counts once."""
    seen = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        else:
            for v in x:
                walk(v)
    for t in trees:
        walk(t)
    return sum(seen.values())


def free_card():
    """Collect what cycles still hold (a server whose frames the profiler
    kept, through its records), then give the allocator's cache back."""
    gc.collect()
    torch.cuda.empty_cache()


def memory_baseline():
    """Collect what cycles still hold (a shut-down server's engine), empty
    the allocator's cache, reset the peak: -> the bytes still allocated,
    from which a phase's peak is counted."""
    free_card()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def margin_and_noise(params, cfg, tokens):
    """(top-2 margin of the last position's logits, the largest distance
    of those logits from the fp32 forward's) of the plain forward on the
    whole ``params`` (cfg.dtype), at the context ``tokens``."""
    from ray_tpu_torch.models.llama import forward
    dev = params["embed"].device
    t = torch.tensor([tokens], device=dev)
    with torch.no_grad():
        lo = forward(params, t, cfg)[0, -1]
        hi = forward(params, t, dataclasses.replace(
            cfg, dtype=torch.float32))[0, -1]
    top = lo.topk(2).values
    return (top[0] - top[1]).item(), (lo - hi).abs().max().item()


def phase_tp_serving(model_config=None, engine_config=None,
                     main_streams=None, main_launches=None, main_peak=None,
                     devices=TP_DEVICES, card="", params=None,
                     ref="phase 4"):
    """17a: phase 4's server with a tp=2 engine (both shards on the card),
    phase 4's requests (the wave admitted at one step, then the prefix
    hit twice, the second under the profiler, as phase 4 sends it; the
    device's busy share printed): each stream equal to phase 4's, or,
    where it parts, the first divergent step named with the tp=1 model's
    top-2 margin there under the bf16 noise (``margin_and_noise``); the
    ragged launches tp x phase 4's; peak memory (over what was allocated
    before the phase, ``main_peak``: phase 4's (before, peak)) and wall
    times beside phase 4's. ``params``: the whole model's weights, handed
    to the engine (which shards them) and read for the margins; ``ref``
    names the run ``main_streams`` and ``main_launches`` come from."""
    from ray_tpu_torch.llm.serve_llm import LLMServer
    from ray_tpu_torch.ops import paged_attention as tpa
    tp = len(devices)
    engine_config = dict(engine_config or MAIN_ENGINE, tp=tp,
                         devices=list(devices))
    if params is not None:
        engine_config["params"] = params
    on_card = engine_config.get("device", "cuda") == "cuda"
    base = memory_baseline() if on_card else None
    t0 = time.monotonic()
    srv = LLMServer(model_config or MAIN_MODEL, engine_config)
    eng = srv.engine
    cfg = eng.cfg
    setup_s = time.monotonic() - t0
    held = held_bytes(eng.params, eng.kv)
    reqs, hit_req = main_requests(cfg.vocab_size, eng.prefill_chunk)
    results = [None] * len(reqs)

    def run(i, kind, prompt, max_tokens):
        body = {"prompt_ids": prompt, "max_tokens": max_tokens}
        if kind == "call":
            results[i] = srv(body)["token_ids"]
            return
        toks = []
        for item in srv.stream(body):
            if item.get("done"):
                break
            toks += item["token_ids"]
        results[i] = toks

    for name in tpa.launch_counts:
        tpa.launch_counts[name] = 0
    try:
        t_wave = time.monotonic()
        admit_together(eng, len(reqs))
        threads = [threading.Thread(target=run, args=(i, *r))
                   for i, r in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            assert not t.is_alive(), "request thread hung"
        wave_s = time.monotonic() - t_wave
        t_hit = time.monotonic()
        hit = srv(hit_req)["token_ids"]
        hit_ms = (time.monotonic() - t_hit) * 1e3
        again, busy = profile_device(lambda: srv(hit_req), eng.device,
                                     hit_ms, focus=("ragged",))
        assert again["token_ids"] == hit
        srv.check_health()
    finally:
        srv.shutdown()
    launches = dict(tpa.launch_counts)
    stats = srv.stats()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    if peak is not None:
        assert peak - base - held <= TP_PEAK_SLACK, \
            f"tp serving peaked {peak - base} bytes over {held} held"
    expected = tp * cfg.n_layers * (stats["ragged_dispatches"]
                                    + eng.decode_chunk
                                    * stats["decode_dispatches"])
    assert launches["ragged_paged_attention"] == expected, \
        (launches, expected)
    assert launches["ragged_paged_attention_reference_cuda"] == 0
    assert launches["ragged_paged_attention_int8"] == (
        expected if eng.kv_dtype == "int8" else 0), launches
    if main_launches is not None:
        assert launches["ragged_paged_attention"] == tp * main_launches, \
            (launches, main_launches)
    assert eng.compiled_step_programs() <= 3
    parted = []
    if main_streams is not None:
        pairs = [(p, got, want) for (_, p, _), got, want in zip(
            reqs, results, main_streams["wave"])]
        pairs.append((hit_req["prompt_ids"], hit, main_streams["hit"]))
        full = None
        for j, (prompt, got, want) in enumerate(pairs):
            assert len(got) == len(want), (j, got, want)
            if got == want:
                continue
            step = next(i for i, (a, b) in enumerate(zip(got, want))
                        if a != b)
            if full is None:    # the tp=1 weights, from the shards
                full = params if params is not None else \
                    eng._fns.gather_params(eng.params)
            margin, noise = margin_and_noise(full, cfg, prompt + want[:step])
            log(f"tp serving: request {j} parts from {ref}'s stream at "
                f"step {step} of {len(want)}: tp=1 top-2 margin {margin:.5f}"
                f", bf16 noise of the logits {noise:.5f}")
            assert margin < max(TP_MARGIN_FLOOR, 2 * noise), \
                f"request {j} parts at a clear margin {margin}"
            parted.append((j, step, margin, noise))
        del full
    n_tok = sum(len(t) for t in results)
    ref_times = "" if "wave_s" not in (main_streams or {}) else (
        f"; {ref}: wave {main_streams['wave_s']:.2f} s, hit "
        f"{main_streams['hit_ms']:.1f} ms")
    mem = "" if peak is None else (
        f", peak memory {peak - base} bytes over the {base} held before "
        f"it, the shards' weights and pools {held}" + (
            "" if main_peak is None else
            f" (phase 4: {main_peak[1] - main_peak[0]} over "
            f"{main_peak[0]})"))
    log(f"tp serving: tp={tp} on {list(devices)}, {cfg.n_layers} layers dim "
        f"{cfg.dim}, {eng.kv_dtype} pools: set-up {setup_s:.1f} s, wave "
        f"{n_tok} tokens in {wave_s:.2f} s, prefix hit alone {hit_ms:.1f} "
        f"ms{ref_times}{mem}; ragged launches "
        f"{launches['ragged_paged_attention']} = {tp} x "
        f"{launches['ragged_paged_attention'] // tp} (int8 pools "
        f"{launches['ragged_paged_attention_int8']}; {ref}: "
        f"{main_launches}); streams equal to {ref}'s: "
        f"{len(reqs) + 1 - len(parted)} of {len(reqs) + 1}; {card}")
    log(f"tp serving: the prefix-hit request under the profiler: {busy}")
    return {"launches": launches["ragged_paged_attention"],
            "setup_s": setup_s, "wave_s": wave_s, "hit_ms": hit_ms,
            "peak_bytes": None if peak is None else peak - base,
            "held_bytes": held,
            "parted": parted, "streams": results + [hit]}


def phase_tp_shards(device, model_config=None, engine_config=None, tp=4,
                    prompt_lens=(300, 20), new_tokens=16):
    """17b: a tp=4 engine at 8B widths (``TP4_MODEL``: 2 layers), all its
    shards on ``device``: every call of the ragged op (each shard's
    attention in each layer) held against the plain version on the same
    inputs, at the shard's geometry; the launches tp x the engine's
    ragged calls of one shard."""
    from ray_tpu_torch.llm import model as M
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    from ray_tpu_torch.ops import paged_attention as tpa
    cfg = model_config_from_dict(model_config or TP4_MODEL)
    kw = dict(engine_config or MAIN_ENGINE)
    kw.pop("device", None)
    eng = InferenceEngine(cfg, tp=tp, devices=[device] * tp, **kw)
    seen = {"calls": 0, "worst": 0.0, "geometry": set()}
    orig = M.ragged_paged_attention

    def checked(q, k_pages, v_pages, *desc, impl=None, **hints):
        out = orig(q, k_pages, v_pages, *desc, impl=impl, **hints)
        ref = tpa.ragged_paged_attention_reference(q, k_pages, v_pages,
                                                   *desc, **hints)
        assert torch.isfinite(out).all()
        seen["worst"] = max(seen["worst"],
                            tolerance_ratios(out, ref).max().item())
        seen["geometry"].add((q.shape[1], k_pages.shape[1]))
        seen["calls"] += 1
        return out

    for name in tpa.launch_counts:
        tpa.launch_counts[name] = 0
    M.ragged_paged_attention = checked
    try:
        rids = [eng.add_request(_prompt(40 + i, n, cfg.vocab_size),
                                new_tokens)
                for i, n in enumerate(prompt_lens)]
        done = {}
        while len(done) < len(rids):
            done.update(eng.step())
    finally:
        M.ragged_paged_attention = orig
    launches = tpa.launch_counts["ragged_paged_attention"]
    calls = tp * cfg.n_layers * (eng.stats["ragged_dispatches"]
                                 + eng.decode_chunk
                                 * eng.stats["decode_dispatches"])
    assert seen["calls"] == calls, (seen, calls)
    if device.type == "cuda":
        assert launches == calls, (launches, calls)
    assert seen["geometry"] == {(cfg.n_heads // tp, cfg.n_kv_heads // tp)}
    assert seen["worst"] <= 1, f"a shard at {seen['worst']} x the limit"
    assert all(len(done[r]) == new_tokens for r in rids)
    log(f"tp shards: tp={tp}, {cfg.n_layers} layers at dim {cfg.dim}, shard "
        f"geometry Hq {cfg.n_heads // tp} Hkv {cfg.n_kv_heads // tp}: "
        f"{seen['calls']} ragged calls each against the plain version, "
        f"worst {seen['worst']:.3f} x the limit; launches {launches}")
    return {"launches": launches, "worst": seen["worst"]}


def flash_kernel_ms(q, k, v, do, causal, scale):
    """Times of the three flash kernels on [BH, L, D] tensors: the
    forward, and dq and dk/dv each alone (the plain backward on CPU
    tensors, both under "dq")."""
    from ray_tpu_torch.ops import flash_attention as tfa
    o, lse = tfa._fwd_call(q, k, v, causal, scale)
    ms = {"fwd": time_ms(lambda: tfa._fwd_call(q, k, v, causal, scale))}
    if not q.is_cuda:
        ms["dq"] = time_ms(lambda: tfa._bwd_call(q, k, v, o, lse, do, causal,
                                                 scale))
        ms["dkv"] = 0.0
        return ms
    _, Lq, D = q.shape
    delta = (do.float() * o.float()).sum(-1)
    pad = -Lq % tfa.LSE_PAD
    lse_p, delta_p = (torch.nn.functional.pad(t, (0, pad))
                      for t in (lse, delta))
    tiles = tfa.default_tiles(q.dtype, D)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ms["dq"] = time_ms(lambda: tfa._launch_dq(
        q, k, v, do, lse_p, delta_p, dq, causal, scale, tiles.dq))
    ms["dkv"] = time_ms(lambda: tfa._launch_dkv(
        q, k, v, do, lse_p, delta_p, dk, dv, causal, scale, tiles.dkv))
    return ms


def ring_block_against_plain(device, shard=RING_SHARD,
                             dtype=torch.bfloat16):
    """17c: the flash block of an off-diagonal rotation (non-causal, one
    rank's block of queries against another's keys, the lse given a
    cotangent as the merge gives it) against the plain versions on the
    same inputs, within phase 6's limits: -> the worst ratio to the limit
    of o, dq, dk and dv, and the lse's largest difference."""
    from ray_tpu_torch.ops import flash_attention as tfa
    B, H, n, D = shard
    scale = D ** -0.5
    g = torch.Generator(device=device).manual_seed(18)
    q, k, v, do = (torch.randn(B * H, n, D, generator=g, device=device)
                   .to(dtype) for _ in range(4))
    dlse = torch.randn(B * H, n, generator=g, device=device)
    o, lse = tfa._fwd_call(q, k, v, False, scale)
    o_ref, lse_ref = tfa._fwd_reference(q, k, v, False, scale)
    grads = tfa._bwd_call(q, k, v, o_ref, lse_ref, do, False, scale,
                          dlse=dlse)
    delta = (do.float() * o_ref.float()).sum(-1) - dlse
    grads_ref = tfa._bwd_reference(q, k, v, lse_ref, do, delta, False,
                                   scale)
    lse_err = (lse - lse_ref).abs().max().item()
    assert lse_err <= LSE_ATOL, f"off-diagonal block: lse off by {lse_err}"
    ratios = {}
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o, *grads),
                               (o_ref, *grads_ref)):
        assert torch.isfinite(got).all(), f"off-diagonal block: {name}"
        ratios[name] = flash_ratios(got, want).max().item()
        assert ratios[name] <= 1, \
            f"off-diagonal block: {name} at {ratios[name]} x the limit"
    log(f"ring blocks: an off-diagonal block ({B * H} x {n} x {n}, D {D}, "
        f"{dtype}, non-causal, an lse cotangent) against the plain "
        f"versions: worst ratio to the limit " + ", ".join(
            f"{k} {r:.3f}" for k, r in ratios.items())
        + f", lse off by {lse_err:.2e}")
    return ratios, lse_err


def phase_ring_blocks(device, shard=RING_SHARD, degrees=RING_DEGREES,
                      dtype=torch.bfloat16, card=""):
    """17c: the ring's per-rotation work (``ring_rotation``: one
    ``flash_attention_block`` + the lse merge) for every virtual rank of
    rings of ``degrees`` ranks, each rank given the KV blocks in the
    order the ring delivers them; the ranks' outputs concatenated and
    the gradients (dq; dk and dv summed over the ranks) against
    ``flash_attention`` over the whole sequence, within phase 6's limits;
    the flash launches of the pass (``ring_blocks`` of each kernel); the
    diagonal and off-diagonal rotation beside one whole-sequence call."""
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.parallel.ring_attention import ring_rotation
    B, H, n, D = shard
    scale = D ** -0.5
    out = {}
    for sp in degrees:
        L = sp * n
        g = torch.Generator(device=device).manual_seed(17)
        q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=device)
                       .to(dtype) for _ in range(4))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        for name in tfa.launch_counts:
            tfa.launch_counts[name] = 0
        outs, lses = [], []
        for idx in range(sp):
            o = torch.zeros(B, n, H, D, dtype=torch.float32, device=device)
            lse = torch.full((B, H, n), float("-inf"), device=device)
            for t in range(sp):
                src = (idx - t) % sp     # the block held at rotation t
                blk = slice(src * n, (src + 1) * n)
                o, lse = ring_rotation(q[:, idx * n:(idx + 1) * n],
                                       k[:, blk], v[:, blk], o, lse, src,
                                       idx, True, scale)
            outs.append(o.to(dtype))
            lses.append(lse)
        o_ring = torch.cat(outs, 1)
        (o_ring.float() * do.float()).sum().backward()
        launches = {name: tfa.launch_counts[name] for name in (
            "flash_attention_fwd", "flash_attention_dq",
            "flash_attention_dkv")}
        if device.type == "cuda":
            assert all(x == ring_blocks(sp) for x in launches.values()), \
                (sp, launches)
            assert tfa.launch_counts["flash_attention_fwd_reference_cuda"] \
                == tfa.launch_counts["flash_attention_bwd_reference_cuda"] \
                == 0
        qw, kw, vw = (t.detach().clone().requires_grad_() for t in (q, k, v))
        ow, lw = tfa.flash_attention_block(qw, kw, vw, True, scale)
        (ow.float() * do.float()).sum().backward()
        ratios = {}
        for label, got, want in (("o", o_ring, ow), ("dq", q.grad, qw.grad),
                                 ("dk", k.grad, kw.grad),
                                 ("dv", v.grad, vw.grad)):
            assert torch.isfinite(got).all(), f"sp {sp}: {label}"
            ratios[label] = flash_ratios(tfa._bhl(got.detach()),
                                         tfa._bhl(want)).max().item()
            assert ratios[label] <= 1, f"sp {sp}: {label} at {ratios[label]}"
        lse_err = (torch.cat(lses, 2) - lw).abs().max().item()
        assert lse_err <= LSE_ATOL, f"sp {sp}: lse off by {lse_err}"
        # per-rotation and whole-sequence times, forward and backward
        with torch.no_grad():
            qb, kb, vb, dob = (tfa._bhl(t.detach()[:, :n])
                               for t in (q, k, v, do))
            qa, ka, va, doa = (tfa._bhl(t.detach()) for t in (q, k, v, do))
            o0 = torch.zeros(B, n, H, D, dtype=torch.float32, device=device)
            l0 = torch.full((B, H, n), float("-inf"), device=device)
            blk = (q.detach()[:, :n], k.detach()[:, :n], v.detach()[:, :n])
            ms = {}
            for label, causal in (("diagonal", True), ("off-diagonal", False)):
                ms[label] = {"rotation": time_ms(
                    lambda c=causal: ring_rotation(*blk, o0, l0, 0,
                                                   0 if c else 1, True,
                                                   scale)),
                    **flash_kernel_ms(qb, kb, vb, dob, causal, scale)}
            ms["whole"] = flash_kernel_ms(qa, ka, va, doa, True, scale)
        pass_ms = {k: sp * ms["diagonal"][k] + (ring_blocks(sp) - sp)
                   * ms["off-diagonal"][k] for k in ms["whole"]}
        out[sp] = {"launches": launches, "ratios": ratios,
                   "lse_err": lse_err, "ms": ms, "pass_ms": pass_ms}
        log(f"ring blocks: sp {sp} (B {B}, H {H}, block {n}, D {D}, "
            f"{dtype}, causal, L {L}): flash launches {launches}; worst "
            f"ratio to the limit " + ", ".join(
                f"{k} {r:.3f}" for k, r in ratios.items())
            + f", lse off by {lse_err:.2e}; ms per rotation: diagonal "
            + ", ".join(f"{k} {x:.4f}" for k, x in ms["diagonal"].items())
            + "; off-diagonal " + ", ".join(
                f"{k} {x:.4f}" for k, x in ms["off-diagonal"].items())
            + f"; the pass's {ring_blocks(sp)} blocks: " + ", ".join(
                f"{k} {x:.4f}" for k, x in pass_ms.items())
            + "; one whole-sequence call: " + ", ".join(
                f"{k} {x:.4f}" for k, x in ms["whole"].items())
            + f"; {card}")
    return out



# ------------------------------- phase 18: DAGs, the RL mesh, the tracker

DAG_REPLAYS = 50          # replays of 18a's captured graph, timed
ACTOR_DAG_N = 200         # executions of 18b's A/B (the JAX test's N)
ACTOR_DAG_SPEEDUP = 2.0   # compiled >= 2x eager (the JAX test's criterion)
TRACKER_RUNS = ("on", "off", "off", "on") * 2   # 18d's A/B, in turns
TRACKER_CALLS = 10_000    # calls of a no-op behind the tracker's wrap
LLM_CALLABLES = ("llm.ragged_step", "llm.decode_loop", "llm.copy_page")


def back_to_back_ms(fn, n):
    """Mean ms of one fn() over n calls enqueued back to back between two
    CUDA events (after one untimed call): the host's time to enqueue a
    call shows wherever it exceeds the device's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def dag_stages(device, shape=FLASH_SHAPE, seed=5):
    """18a's graph: ``project`` (x [B, L, H, D] through one bf16 matmul
    into k and v), ``attend`` (the flash forward, causal, with x itself
    as the queries: it reads the input and the projection, so the graph
    is a diamond) and ``output`` (the output projection) as remote
    functions bound under one InputNode; -> (the DAG node, the stages'
    plain functions)."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.ops.flash_attention import flash_attention

    B, H, L, D = shape
    g = torch.Generator(device=device).manual_seed(seed)
    w_kv = (torch.randn(H * D, 2 * H * D, generator=g, device=device)
            * (H * D) ** -0.5).bfloat16()
    w_o = (torch.randn(H * D, H * D, generator=g, device=device)
           * (H * D) ** -0.5).bfloat16()

    @ray_tpu_torch.remote
    def project(x, w):
        kv = torch.matmul(x.reshape(B, L, H * D), w)
        k, v = kv.reshape(B, L, 2, H, D).unbind(2)
        return k.contiguous(), v.contiguous()

    @ray_tpu_torch.remote
    def attend(x, kv):
        return flash_attention(x, *kv, causal=True)

    @ray_tpu_torch.remote
    def output(a, w):
        return torch.matmul(a.reshape(B, L, H * D), w)

    with InputNode() as inp:
        dag = output.bind(attend.bind(inp, project.bind(inp, w_kv)), w_o)
    return dag, (project, attend, output), (w_kv, w_o)


def phase_compiled_dag(device, shape=FLASH_SHAPE, replays=DAG_REPLAYS):
    """18a: a compiled pure-function DAG around one flash forward at phase
    6's shape (bf16, causal), captured once in a CUDA graph and replayed;
    the replay's output equal to the stages run eagerly on the card to
    the bit, the flash stage within phase 6's limits of the plain
    version, a result kept from the first ``execute`` unchanged by the
    next, and the flash launches, counted from 0, equal to captures +
    replays (the plain version never on CUDA). Prints the capture time
    and the replay and eager ms; -> {"launches", "captures",
    "replays"}."""
    from ray_tpu_torch.dag import experimental_compile
    from ray_tpu_torch.ops import flash_attention as tfa

    B, H, L, D = shape
    dag, (project, attend, output), (w_kv, w_o) = dag_stages(device, shape)
    g = torch.Generator(device=device).manual_seed(6)
    xs = [torch.randn(B, L, H, D, generator=g, device=device).bfloat16()
          for _ in range(2)]
    compiled = experimental_compile(dag)
    for name in tfa.launch_counts:
        tfa.launch_counts[name] = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    first = compiled.execute(xs[0])
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t0
    kept = first.clone()
    second = compiled.execute(xs[1])
    replay_ms = back_to_back_ms(lambda: compiled.execute(xs[1]), replays)
    out = compiled.execute(xs[1])
    executes = 4 + replays
    launches = dict(tfa.launch_counts)
    captures = compiled.captures()
    assert captures == 1, captures
    assert launches["flash_attention_fwd"] == captures + executes, \
        (launches, captures, executes)
    assert launches["flash_attention_fwd_reference_cuda"] == 0, launches
    assert torch.equal(first, kept), \
        "the second execute overwrote the first one's result"

    def eager(x):
        kv = project.underlying_function(x, w_kv)
        a = attend.underlying_function(x, kv)
        return output.underlying_function(a, w_o), kv, a

    eager_ms = back_to_back_ms(lambda: eager(xs[1]), replays)
    want, kv, a = eager(xs[1])
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    for got in (second, out):
        assert torch.equal(got, want), \
            f"replay differs from eager: {(got - want).abs().max().item()}"

    def bh(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, L, D)

    plain, _ = tfa._fwd_reference(bh(xs[1]), bh(kv[0]), bh(kv[1]), True,
                                  D ** -0.5)
    ratio = flash_ratios(bh(a), plain).max().item()
    assert ratio <= 1, f"the flash stage at {ratio} x phase 6's limit"
    log(f"18a compiled DAG (project -> flash forward -> output, B {B} H "
        f"{H} L {L} D {D} bf16, causal): captured in {capture_s:.2f} s "
        f"(warm-up and capture), replay {replay_ms:.4f} ms a call over "
        f"{replays} (input copy, graph, output clone), eager "
        f"{eager_ms:.4f} ms; replay equal to eager to the bit; the flash "
        f"stage {ratio:.3f} x the limit of the plain version; flash "
        f"launches {launches['flash_attention_fwd']} = {captures} capture "
        f"+ {executes} replays")
    return {"launches": launches["flash_attention_fwd"],
            "captures": captures, "replays": executes,
            "capture_s": capture_s, "replay_ms": replay_ms,
            "eager_ms": eager_ms}


def phase_actor_dag(n=ACTOR_DAG_N, speedup=ACTOR_DAG_SPEEDUP):
    """18b: tests/test_jobs_dag_workflow.py's compiled actor DAG on the
    cluster runtime (a fresh ``init(num_cpus=2)``): two actors chained
    through shm channels, ordering over 20 pipelined executions, an error
    travelling the channel with the pipeline working after it, then the
    JAX test's done criterion: compiled >= 2x eager chained calls at N
    ``n`` (``speedup``); ``teardown`` and ``shutdown``. -> the two
    rates."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode, experimental_compile

    t0 = time.monotonic()
    rt.init(num_cpus=2, _system_config={
        "object_store_memory_bytes": 256 << 20})
    try:
        @rt.remote(num_cpus=0)
        class Doubler:
            def f(self, x):
                if x == "boom":
                    raise ValueError("boom-input")
                return x * 2

        @rt.remote(num_cpus=0)
        class AddOne:
            def g(self, x):
                return x + 1

        a, b = Doubler.remote(), AddOne.remote()
        assert rt.get(b.g.remote(rt.get(a.f.remote(1), timeout=120)),
                      timeout=120) == 3
        with InputNode() as inp:
            dag = b.g.bind(a.f.bind(inp))
        compiled = experimental_compile(dag)
        try:
            refs = [compiled.execute(i) for i in range(20)]
            assert [r.get() for r in refs] == [2 * i + 1 for i in range(20)]
            bad, ok = compiled.execute("boom"), compiled.execute(5)
            try:
                bad.get()
                raise AssertionError("the error did not travel the channel")
            except ValueError as e:
                assert "boom-input" in str(e), e
            assert ok.get() == 11
            t = time.perf_counter()
            for i in range(n):
                rt.get(b.g.remote(rt.get(a.f.remote(i))))
            eager = n / (time.perf_counter() - t)
            t = time.perf_counter()
            refs = [compiled.execute(i) for i in range(n)]
            out = [r.get() for r in refs]
            rate = n / (time.perf_counter() - t)
            assert out == [2 * i + 1 for i in range(n)]
        finally:
            compiled.teardown()
    finally:
        rt.shutdown()
    log(f"18b compiled actor DAG (two actors, shm channels): ordering over "
        f"20 and the error through the channel checked; N {n}: eager "
        f"chained calls {eager:.0f}/s, compiled {rate:.0f}/s, "
        f"{rate / eager:.2f}x (criterion {speedup}x); the phase "
        f"{time.monotonic() - t0:.1f} s")
    assert rate >= speedup * eager, (eager, rate)
    return {"eager_per_s": eager, "compiled_per_s": rate}


def rl_mesh_batch(name, algo):
    """One update's input for ``name``: PPO's and IMPALA's from the
    algorithm's own runners, BC's 512 rows from its dataset."""
    if name == "BC":
        return next(iter(algo.config.dataset.iter_batches(
            batch_size=algo.config.batch_size, drop_last=True)))
    return learner_batch(name, algo)


def phase_rl_mesh(device):
    """18c: PPO, IMPALA and BC through ``build(mesh=)`` on a mesh of one
    rank (a process group of world size 1: NCCL on the card, gloo on the
    CPU) in the local-mode runtime, phase 11's settings: one update of
    each on a batch from its runners (BC: its dataset) equal to the bit
    to the same update of ``build(mesh=None)``'s learner from the same
    parameters (PPO with the same permutations); then one ``train()`` of
    each mesh algorithm, through the first rank's sampling and
    broadcasts."""
    import socket

    import numpy as np
    import torch.distributed as dist

    import ray_tpu_torch
    from ray_tpu_torch.data import from_numpy
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.rllib import BCConfig
    from ray_tpu_torch.train import param_leaves

    t0 = time.monotonic()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    ray_tpu_torch.init(local_mode=True, num_cpus=4)
    algos = []
    try:
        mesh = build_mesh(MeshSpec(), device.type)
        rng = np.random.default_rng(12)
        rows = from_numpy({"obs": rng.normal(size=(1024, 4)).astype(
            np.float32), "action": rng.integers(0, 2, 1024).astype(np.int32)})
        configs = {name: rl_cases()[name][0] for name in ("PPO", "IMPALA")}
        configs["BC"] = BCConfig(dataset=rows, **BC_CONFIG)
        line = []
        for name, cfg in configs.items():
            sharded, plain = (cfg.build(device=device, mesh=m)
                              for m in (mesh, None))
            algos += [sharded, plain]
            for x, y in zip(param_leaves(sharded.params),
                            param_leaves(plain.params)):
                assert torch.equal(x, y), f"{name}: built apart"
            batch = rl_mesh_batch(name, plain)
            kw = {}
            if name == "PPO":
                g = torch.Generator().manual_seed(11)
                kw["perms"] = [torch.randperm(batch["rewards"].size,
                                              generator=g).numpy()
                               for _ in range(cfg.num_epochs)]
            got = sharded.learner.update(sharded.params, batch, **kw)
            want = plain.learner.update(plain.params, batch, **kw)
            for x, y in zip(param_leaves(got[0]), param_leaves(want[0])):
                assert torch.equal(x, y), f"{name}: mesh update differs"
            assert got[1] == want[1], (name, got[1], want[1])
            t = time.monotonic()
            res = sharded.train()
            loss = res["learner"].get("loss", res["learner"].get("bc_loss"))
            assert np.isfinite(loss), (name, res)
            line.append(f"{name} {json.dumps(got[1])}, one train() on the "
                        f"mesh {time.monotonic() - t:.2f} s")
    finally:
        for algo in algos:
            algo.stop()
        ray_tpu_torch.shutdown()
        dist.destroy_process_group()
    backend = "nccl" if device.type == "cuda" else "gloo"
    log(f"18c RL on a one-rank {backend} mesh: one update each equal to "
        f"the bit to mesh=None: "
        f"{'; '.join(line)}; the phase {time.monotonic() - t0:.1f} s")


def tracker_records():
    """The process tracker's compile records of the engine's step
    functions: {callable: compiles}."""
    from ray_tpu_torch.util import compile_tracker
    tracker = compile_tracker.get_global()
    assert tracker is not None, "the compile tracker is off"
    return {n: (tracker.callable_stats(n) or {}).get("compiles", 0)
            for n in LLM_CALLABLES}


def phase_tracker(programs, model_config=None, engine_config=None,
                  runs=TRACKER_RUNS):
    """18d, right after phase 4 (the process's first engine): the compile
    tracker's records of ``llm.*`` equal the step programs phase 4
    dispatched (at most 3) and no ``llm_compile_invariant_breach`` event
    is staged; then phase 4's engine (its model and engine settings, the
    prefix cache off so that each run does the same work) serves phase
    4's first wave in turns with the tracker's wraps on and off: the
    streams equal, no new record, the ragged launches counted from 0 the
    engine's count; and the wrap's own host cost a call (a no-op behind
    the same wrap and probe, ``TRACKER_CALLS`` calls); -> the ragged
    launches."""
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    from ray_tpu_torch.ops import paged_attention as tpa
    from ray_tpu_torch.util import compile_tracker

    records = tracker_records()
    breaches = [e for e in compile_tracker.get_global()
                .drain_journal_events()
                if e["type"] == "llm_compile_invariant_breach"]
    assert sum(records.values()) == programs <= 3, (records, programs)
    assert not breaches, breaches
    cfg = model_config_from_dict(model_config or MAIN_MODEL)
    eng = InferenceEngine(cfg, **{**(engine_config or MAIN_ENGINE),
                                  "prefix_cache": False})
    wrapped = {n: getattr(eng._fns, n) for n in
               ("ragged_step", "decode_loop", "copy_page")}
    plain = {n: f.__rtpu_compile_wrapped__ for n, f in wrapped.items()}
    reqs, _ = main_requests(cfg.vocab_size, eng.prefill_chunk)
    for name in tpa.launch_counts:
        tpa.launch_counts[name] = 0
    turns, streams = [], []

    def sync():
        if eng.device.type == "cuda":
            torch.cuda.synchronize()

    for mode in runs:
        for n, f in (wrapped if mode == "on" else plain).items():
            setattr(eng._fns, n, f)
        sync()
        t = time.monotonic()
        rids = [eng.add_request(prompt, max_tokens)
                for _, prompt, max_tokens in reqs]
        done = {}
        for _ in range(1000):
            done.update(eng.step())
            if len(done) == len(rids):
                break
        sync()
        turns.append((mode, time.monotonic() - t))
        streams.append([done[r] for r in rids])
    launches = dict(tpa.launch_counts)
    stats = dict(eng.stats)
    expected = cfg.n_layers * (stats["ragged_dispatches"]
                               + eng.decode_chunk
                               * stats["decode_dispatches"])
    after = tracker_records()
    noop = compile_tracker.get_global().wrap(
        lambda: None, name="chip_smoke.noop",
        probe=eng._fns.compiled_step_programs)
    t = time.perf_counter()
    for _ in range(TRACKER_CALLS):
        noop()
    wrap_us = (time.perf_counter() - t) / TRACKER_CALLS * 1e6
    dispatches = stats["ragged_dispatches"] + stats["decode_dispatches"] \
        + stats["cow_copies"]
    del eng, wrapped, plain, sync
    assert all(s == streams[0] for s in streams), "the tracker moved a token"
    assert after == records, (records, after)
    assert launches["ragged_paged_attention"] == expected, \
        (launches, expected)
    assert launches["ragged_paged_attention_reference_cuda"] == 0, launches
    on, off = (sum(s for m, s in turns if m == mode)
               / sum(m == mode for m, _ in turns) for mode in ("on", "off"))
    log(f"18d compile tracker: phase 4's records {json.dumps(records)} = "
        f"{programs} step programs, no breach event; phase 4's first wave "
        f"on its engine (prefix cache off) in turns "
        f"{', '.join(f'{m} {s:.3f} s' for m, s in turns)}: "
        f"with the tracker {on:.3f} s, without {off:.3f} s "
        f"({(on / off - 1) * 100:+.2f}%); streams equal, no new record; "
        f"the wrap's own cost {wrap_us:.2f} us a call, "
        f"{dispatches} dispatches: "
        f"{wrap_us * dispatches / len(runs) / 1e3:.3f} ms a wave; "
        f"ragged launches {launches['ragged_paged_attention']} = the "
        f"engine's count")
    return launches["ragged_paged_attention"]


#: phase 19: each node's CPUs, the placement group's one bundle, and the
#: telemetry periods its cluster's daemons and workers run with (so that
#: the CLI's readings land within a second or two)
OPS_NODE_CPUS = 4
OPS_BUNDLE = {"GPU": 1, "CPU": 1}
OPS_TELEMETRY = {"metrics_export_period_s": 1.0, "hw_sampler_period_s": 0.5}
#: 19e's and 19f's server: 8B widths at 2 layers
OPS_AUTOSCALE_MODEL = dict(MAIN_MODEL, n_layers=2)
OPS_AUTOSCALE_TOKENS = 16
#: 19f: the A3 machine type the provider provisions, the bundle that
#: names the card's model, and 19f's bound on its own time (s)
OPS_GCE_MACHINE = "a3-highgpu-1g"
OPS_GCE_BUNDLE = {"GPU": 1, "GPU-H100": 1}
OPS_GCE_BUDGET_S = 40.0
#: the CLI's readings (card memory, request records, log records) reach
#: the head on the workers' next telemetry flush: poll at most this long
OPS_POLL_S = 30.0

#: phase 19b's job: connect through RTPT_ADDRESS, reserve the card in a
#: placement group, serve phase 4's requests from phase 14's server in the
#: bundle and write what it saw to the file its argument names. The actor
#: and the group outlive the job (detached), for 19c and 19d.
OPS_JOB = """\
import json, os, sys, time
args = json.loads(sys.argv[1])
sys.path.insert(0, args["repo"])
import chip_smoke
import ray_tpu_torch as rt
from ray_tpu_torch.util.placement_group import placement_group
rt.init(address=os.environ["RTPT_ADDRESS"])
t0 = time.monotonic()
pg = placement_group([args["bundle"]], strategy="STRICT_PACK",
                     name="phase19")
pg.ready(300)
pg_s = time.monotonic() - t0
server = rt.remote(num_gpus=1, name=args["actor"], namespace="phase19",
                   lifetime="detached")(chip_smoke.MainServer)
a = server.options(placement_group=pg,
                   placement_group_bundle_index=0).remote(
    args["model"], args["engine"])
where = rt.get(a.where.remote(), timeout=900)
device = rt.get(a.device.remote(), timeout=60)
got = rt.get(a.answer.remote(), timeout=900)
launches, expected, stats = rt.get(a.counts.remote(), timeout=60)
with open(args["out"], "w") as f:
    json.dump({"pg": pg.id.hex(), "pg_s": pg_s,
               "bundle_node": pg.bundle_node(0), "where": where,
               "device": device, "wave": got["wave"], "hit": got["hit"],
               "e2e_s": got["e2e_s"], "launches": launches,
               "expected": expected, "stats": stats,
               "job_id": os.environ["RTPT_JOB_ID"]}, f)
print("phase 19 job: served", len(got["wave"]) + 1, "requests; ragged "
      "launches", launches["ragged_paged_attention"], "of", expected)
rt.shutdown()
"""


def ops_cli(address, *args, timeout=120):
    """``python -m ray_tpu_torch <args> --address <address>``: -> its
    exit code, stdout, stderr and seconds."""
    t = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", *args, "--address",
         address], cwd=str(REPO), capture_output=True, text=True,
        timeout=timeout)
    return out.returncode, out.stdout, out.stderr, time.monotonic() - t


def poll(what, fn, timeout=OPS_POLL_S, period=0.25):
    """Call ``fn`` until it returns a true value: -> that value and the
    seconds it took."""
    t0 = time.monotonic()
    while True:
        got = fn()
        if got:
            return got, time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"{what}: not seen in {timeout} s")
        time.sleep(period)


@contextlib.contextmanager
def daemon_config(values):
    """The daemons and workers a cluster started inside this block run
    with ``values`` (they read the starting process's config)."""
    from ray_tpu_torch.core import config as config_mod
    old = {k: getattr(config_mod.GlobalConfig, k) for k in values}
    config_mod.GlobalConfig.apply(values)
    try:
        yield
    finally:
        config_mod.GlobalConfig.apply(old)


def phase_operations(model_config=None, engine_config=None,
                     main_streams=None, autoscale_model=None,
                     card="the CPU", stand_in_path=()):
    """Phase 19: ``phase_ops_cluster`` (19a-d), ``phase_autoscale`` (19e)
    then ``phase_gce`` (19f; ``stand_in_path``: directories put first on
    the stand-in VM's PATH). -> their summaries, with the ragged launches
    of all three."""
    t_phase = time.monotonic()
    summary = phase_ops_cluster(model_config, engine_config, main_streams,
                                card)
    autoscale_model = autoscale_model or OPS_AUTOSCALE_MODEL
    engine_config = engine_config or MAIN_ENGINE
    reference = autoscale_reference(autoscale_model, engine_config)
    summary.update(phase_autoscale(autoscale_model, engine_config,
                                   reference))
    summary.update(phase_gce(autoscale_model, engine_config, reference,
                             stand_in_path, card))
    summary["launches"] = summary["job_launches"] \
        + summary["scale_launches"] + summary["gce_launches"]
    log(f"phase 19: {time.monotonic() - t_phase:.1f} s")
    return summary


def phase_ops_cluster(model_config=None, engine_config=None,
                      main_streams=None, card="the CPU"):
    """19a. a multi-node ``Cluster`` (a head node, node A with no card,
    node B with the card); 19b. a job (``JobSubmissionClient``) whose
    entrypoint reserves the card in a placement group and serves phase
    4's requests from phase 14's server in the bundle: its streams must
    equal ``main_streams`` and its ragged launches the engine's count;
    19c. the CLI, the dashboard's state and ``/metrics`` against the live
    cluster; 19d. ``remove_placement_group`` ends the worker and the
    card's memory returns. -> a summary."""
    import os
    import shlex
    import tempfile
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.ids import PlacementGroupID
    from ray_tpu_torch.dashboard import Dashboard
    from ray_tpu_torch.jobs import SUCCEEDED, JobSubmissionClient
    from ray_tpu_torch.util import prometheus
    from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                    remove_placement_group)
    model_config = model_config or MAIN_MODEL
    engine_config = engine_config or MAIN_ENGINE
    cuda = engine_config.get("device", "cuda") == "cuda"
    reset_port_launch_counts()
    summary = {}
    if cuda:
        free_card()
        free_before, total = torch.cuda.mem_get_info()

    # 19a: the cluster
    t0 = time.monotonic()
    with daemon_config(OPS_TELEMETRY):
        cluster = Cluster()
        head_node = cluster.add_node(num_cpus=1)
        node_a = cluster.add_node(num_cpus=OPS_NODE_CPUS)
        node_b = cluster.add_node(num_cpus=OPS_NODE_CPUS,
                                  resources={"GPU": 1})
    pids = {"head": cluster.head_proc.pid, "head node": head_node.proc.pid,
            "node A": node_a.proc.pid, "node B": node_b.proc.pid}
    tmp = tempfile.TemporaryDirectory(prefix="phase19-")
    try:
        rt.init(address=cluster.address, _system_config=OPS_TELEMETRY)
        boot_s = time.monotonic() - t0
        res = rt.cluster_resources()
        gpus = {n["NodeID"]: n["Resources"].get("GPU", 0.0)
                for n in rt.nodes()}
        log(f"19a: Cluster of a head, a head node and nodes A and B booted "
            f"in {boot_s:.2f} s; resources {res}; GPUs per node "
            f"{ {k[:12]: v for k, v in gpus.items()} }")
        assert res.get("GPU") == 1.0, res
        assert gpus == {head_node.node_id: 0.0, node_a.node_id: 0.0,
                        node_b.node_id: 1.0}, gpus
        for name, pid in pids.items():
            assert not holds_cuda(pid), f"the {name} daemon holds CUDA"

        # 19b: the job
        out_path = os.path.join(tmp.name, "job.json")
        script = os.path.join(tmp.name, "phase19_job.py")
        with open(script, "w") as f:
            f.write(OPS_JOB)
        args = {"repo": str(REPO), "model": model_config,
                "engine": engine_config, "bundle": OPS_BUNDLE,
                "actor": "llm8b_job", "out": out_path}
        client = JobSubmissionClient()
        t0 = time.monotonic()
        job_id = client.submit_job(entrypoint=(
            f"{shlex.quote(sys.executable)} {shlex.quote(script)} "
            f"{shlex.quote(json.dumps(args))}"))
        status = client.wait(job_id, timeout=1200)
        job_s = time.monotonic() - t0
        logs = client.get_job_logs(job_id)
        assert status == SUCCEEDED, (status, client.get_job_info(job_id),
                                     logs[-4000:])
        with open(out_path) as f:
            job = json.load(f)
        job["e2e_s"] = {int(k): v for k, v in job["e2e_s"].items()}
        where = job["where"]
        log(f"19b: job {job_id} {status} {job_s:.2f} s after submission; "
            f"its placement group ready in {job['pg_s']:.2f} s, bundle 0 "
            f"on node {job['bundle_node'][:12]} (node B "
            f"{node_b.node_id[:12]}); the server's worker pid "
            f"{where['pid']}, CUDA_VISIBLE_DEVICES {where['visible']!r}, "
            f"built in {where['build_s']:.2f} s, device {job['device']}; "
            f"the job's last line: {logs.strip().splitlines()[-1]!r}")
        assert job["bundle_node"] == node_b.node_id, job["bundle_node"]
        assert job["job_id"] == job_id
        assert where["visible"] == "0", where
        if cuda:
            assert job["device"]["type"] == "cuda", job["device"]
            assert holds_cuda(where["pid"])
        for i in sorted(job["e2e_s"]):
            theirs = main_streams["e2e_s"].get(i) if main_streams else None
            log(f"19b: request {i}: {job['e2e_s'][i] * 1e3:.1f} ms in the "
                f"job's server" + ("" if theirs is None else
                                   f", {theirs * 1e3:.1f} ms in phase 4"))
        check_streams(job, main_streams)
        launches, expected = job["launches"], job["expected"]
        log(f"19b: the job's {len(job['wave']) + 1} token streams "
            + ("equal phase 4's" if main_streams is not None else
               "(no phase 4 run to compare)")
            + f"; the worker's launches {launches}, the engine's count "
            f"{expected}")
        if cuda:
            assert launches["ragged_paged_attention"] == expected, \
                (launches, expected)
        else:
            assert not any(launches.values()), launches
        assert launches["ragged_paged_attention_reference_cuda"] == 0
        summary.update(boot_s=boot_s, job_s=job_s, pg_s=job["pg_s"],
                       job_launches=launches["ragged_paged_attention"],
                       job_expected=expected)

        # 19c: the CLI, the dashboard and /metrics on the live cluster
        address = cluster.address
        cli_s = {}

        def cli(*cmd):
            rc, out, err, secs = ops_cli(address, *cmd)
            cli_s[" ".join(cmd[:2] if cmd[0] == "list" else cmd[:1])] = secs
            assert rc == 0, (cmd, rc, out[-2000:], err[-2000:])
            return out, err

        out, _ = cli("status")
        assert "3/3 nodes alive" in out, out
        assert re.search(r"GPU: \S+/1 available", out), out
        out, _ = cli("list", "nodes", "--format", "json")
        rows = {r["node_id"]: r for r in json.loads(out)}
        assert rows[node_b.node_id]["resources"].get("GPU") == 1, rows
        out, _ = cli("list", "actors", "--format", "json")
        actors = [r for r in json.loads(out) if r["class"] == "MainServer"]
        assert [(a["state"], a["node_id"]) for a in actors] == \
            [("ALIVE", node_b.node_id)], actors

        def top_row():
            out, _ = cli("top")
            row = next(ln for ln in out.splitlines()
                       if ln.startswith(node_b.node_id[:12]))
            return row if not row.endswith("-") else None

        if cuda:
            row, _ = poll("the card's memory in `top`", top_row)
            used = row.split()[-1].split("/")[0]
            assert not used.startswith("0B"), row
        else:
            row = top_row() or "-"
        rids = {}

        def records():
            out, _ = cli("requests", "--format", "json")
            recs = json.loads(out) if out.strip().startswith("[") else []
            rids.update((r["rid"], r) for r in recs if r.get("ttft"))
            return len(rids) >= len(job["wave"]) + 1

        poll("the job's request records at the head", records)
        out, _ = cli("requests")
        assert out.count("(TTFT)") >= len(job["wave"]) + 1, out[-2000:]
        rid = sorted(rids)[0]
        out, _ = cli("trace", "--request", rid)
        assert f"request {rid}" in out and "(TTFT)" in out, out

        def log_lines():
            _, err = cli("logs", "--request", rid)
            return int(re.search(r"\((\d+) record", err).group(1))

        n_logs, _ = poll("the request's log records", log_lines)
        dash = Dashboard(address)
        try:
            base = f"http://127.0.0.1:{dash.port}"
            with urllib.request.urlopen(f"{base}/api/state",
                                        timeout=30) as r:
                state = json.loads(r.read())
            assert {n["node_id"] for n in state["nodes"]} == \
                {head_node.node_id, node_a.node_id, node_b.node_id}
            assert [(pg["name"], pg["nodes"]) for pg in
                    state["placement_groups"]] == \
                [("phase19", [node_b.node_id])], state["placement_groups"]

            def scrape():
                with urllib.request.urlopen(f"{base}/metrics",
                                            timeout=30) as r:
                    fams = prometheus.parse(r.read().decode())
                mem = [s for s in fams.get("gpu_memory_used_bytes", {})
                       .get("samples", ())
                       if s[1].get("node") == node_b.node_id[:12]
                       and s[2] > 0]
                if (mem or not cuda) and "llm_ttft_seconds" in fams:
                    return fams, mem
                return None

            (fams, mem), _ = poll("/metrics' card memory and latency",
                                  scrape)
        finally:
            dash.stop()
        assert fams["llm_ttft_seconds"]["type"] == "histogram"
        log(f"19c: the CLI against the live cluster: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in cli_s.items())
            + f"; `top`'s row for node B: {row!r}; {len(rids)} request "
            f"records with TTFTs "
            f"{[round(r['ttft'] * 1e3, 1) for r in rids.values()]} ms; "
            f"`trace --request {rid}` and {n_logs} log records of it; the "
            f"dashboard's state lists the three nodes and the placement "
            f"group; /metrics: node B's gpu_memory_used_bytes "
            f"{[s[2] for s in mem]}, the llm_* series "
            f"{sorted(f for f in fams if f.startswith('llm_'))}")
        summary["cli_s"] = cli_s

        # 19d: remove the placement group: the worker ends, the card frees
        pg = PlacementGroup(PlacementGroupID(bytes.fromhex(job["pg"])),
                            [dict(OPS_BUNDLE)], "STRICT_PACK", "phase19")
        t0 = time.monotonic()
        remove_placement_group(pg)
        gone_s = wait_gone(where["pid"])
        if cuda:
            free_after, _ = torch.cuda.mem_get_info()
            log(f"19d: remove_placement_group -> the server's worker gone "
                f"in {gone_s:.2f} s; free device memory {free_before} "
                f"bytes at the phase's start, {free_after} after (of "
                f"{total}); {card}")
            assert free_after >= free_before - MEMORY_RETURN_SLACK, \
                (free_before, free_after)
        else:
            log(f"19d: remove_placement_group -> the server's worker gone "
                f"in {gone_s:.2f} s")
        summary["pg_remove_s"] = gone_s
    finally:
        rt.shutdown()
        cluster.shutdown()
        tmp.cleanup()
    for name, pid in pids.items():
        wait_gone(pid, timeout=30)
    return summary


def autoscale_reference(model_config, engine_config):
    """19e's and 19f's request and a direct engine's answer to it: ->
    (prompt, tokens)."""
    here = MainServer(model_config, engine_config)
    try:
        prompt = _prompt(19, 40, here.srv.engine.cfg.vocab_size)
        want = here.one(prompt, OPS_AUTOSCALE_TOKENS)
    finally:
        here.srv.shutdown()
        del here
    if engine_config.get("device", "cuda") == "cuda":
        free_card()
    return prompt, want


def phase_autoscale(model_config, engine_config, reference):
    """19e. an ``AutoscalingCluster`` (a head node with no card, node
    types cpu and h100) whose pending ``{"GPU": 1}`` bundle launches one
    h100 node and no cpu node, where ``model_config``'s server answers
    ``reference``'s prompt with its tokens (a direct engine's), and which
    drains once the group is removed. -> a summary."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import autoscaler as asc
    from ray_tpu_torch.runtime import instance_manager as im
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    cuda = engine_config.get("device", "cuda") == "cuda"
    summary = {}
    prompt, want = reference
    t0 = time.monotonic()
    with daemon_config(OPS_TELEMETRY):
        scaling = asc.AutoscalingCluster(
            head_resources={"CPU": 2.0}, idle_timeout_s=2.0,
            node_types={
                "cpu": asc.NodeTypeSpec({"CPU": OPS_NODE_CPUS, "GPU": 0.0},
                                        max_workers=1),
                "h100": asc.NodeTypeSpec(
                    {"CPU": OPS_NODE_CPUS, "GPU": 1.0}, max_workers=1)})
    scaler = scaling.autoscaler
    scaler.poll_period_s = 0.25
    node_pid = None
    try:
        rt.init(address=scaling.address,
                _system_config={**OPS_TELEMETRY,
                                "infeasible_grace_s": 300.0})
        boot_s = time.monotonic() - t0
        assert rt.cluster_resources().get("GPU", 0.0) == 0.0
        t0 = time.monotonic()
        pg = placement_group([{"GPU": 1}], strategy="STRICT_PACK")
        (rec,), up_s = poll("the GPU node's registration", lambda: [
            r for r in scaler.im.records(im.RUNNING)], timeout=120)
        pg.ready(120)
        ready_s = time.monotonic() - t0
        types = sorted(r.node_type for r in scaler.im.records())
        assert types == ["h100"], types
        assert pg.bundle_node(0) == rec.node_id
        node_pid = rec.metadata["pid"]
        server = rt.remote(num_gpus=1)(MainServer)
        a = server.options(placement_group=pg,
                           placement_group_bundle_index=0).remote(
            model_config, engine_config)
        where = rt.get(a.where.remote(), timeout=600)
        got = rt.get(a.one.remote(prompt, OPS_AUTOSCALE_TOKENS),
                     timeout=600)
        launches_e, expected_e, _ = rt.get(a.counts.remote(), timeout=60)
        assert where["visible"] == "0", where
        assert got == want, (got, want)
        if cuda:
            assert launches_e["ragged_paged_attention"] == expected_e, \
                (launches_e, expected_e)
        assert launches_e["ragged_paged_attention_reference_cuda"] == 0
        t0 = time.monotonic()
        remove_placement_group(pg)
        _, drain_s = poll("the GPU node's drain", lambda: all(
            r.state == im.TERMINATED for r in scaler.im.records()),
            timeout=120)
        gone_s = wait_gone(node_pid, timeout=30)
        records = [(r.node_type, [s for s, _ in r.history])
                   for r in scaler.im.records()]
        assert records == [("h100", [im.REQUESTED, im.ALLOCATED,
                                     im.RUNNING, im.DRAINING,
                                     im.TERMINATED])], records
        assert scaler.provider.list_live() == {}
        log(f"19e: AutoscalingCluster booted in {boot_s:.2f} s (the head "
            f"node: no card); a pending {{'GPU': 1}} bundle: the h100 node "
            f"registered {up_s:.2f} s after the demand, the group ready in "
            f"{ready_s:.2f} s; no cpu node launched; the server at "
            f"{model_config} answered {len(got)} tokens equal to a "
            f"direct engine's (worker pid {where['pid']}, built in "
            f"{where['build_s']:.2f} s), ragged launches "
            f"{launches_e['ragged_paged_attention']} of "
            f"{expected_e}; the group removed -> drained and TERMINATED in "
            f"{drain_s:.2f} s, the node daemon gone {gone_s:.2f} s later; "
            f"the instance's states {records[0][1]}")
        summary.update(scale_up_s=up_s, scale_ready_s=ready_s,
                       drain_s=drain_s,
                       scale_launches=launches_e["ragged_paged_attention"])
    finally:
        rt.shutdown()
        scaling.shutdown()
    if node_pid is not None:
        wait_gone(node_pid, timeout=30)
    return summary


class FakeCompute:
    """19f's Compute Engine transport, answering in the API's own words.
    An insert runs the instance's own ``startup-script`` with bash, as a
    local process on card 0 (``CUDA_VISIBLE_DEVICES=0``): the stand-in
    VM, whose ``python3`` is this interpreter and whose PATH starts with
    ``path``. A GET of the instance answers PROVISIONING until its node
    registers with the head, RUNNING after, TERMINATED once the process
    has exited; a DELETE ends the process group and drops the instance;
    a GET of the collection lists the instances."""

    def __init__(self, head_addr, path=()):
        import os
        import tempfile
        from ray_tpu_torch.runtime.protocol import RpcClient
        self.requests = []      # (method, url, body, monotonic time)
        self.instances = {}     # name -> {"proc", "labels", "log"}
        self._head = RpcClient(head_addr, name="fake-compute")
        self._dir = tempfile.TemporaryDirectory(prefix="phase19f-")
        bin_dir = os.path.join(self._dir.name, "bin")
        os.mkdir(bin_dir)
        python3 = os.path.join(bin_dir, "python3")
        with open(python3, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(python3, 0o755)
        self._env = dict(
            os.environ, CUDA_VISIBLE_DEVICES="0",
            PATH=os.pathsep.join([bin_dir, *map(str, path),
                                  os.environ.get("PATH", "")]),
            PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get(
                "PYTHONPATH", "")]))
        self._lock = threading.Lock()   # the request log
        self._api = threading.Lock()    # one request served at a time

    def request(self, method, url, body=None):
        with self._lock:
            self.requests.append((method, url, body, time.monotonic()))
        name = url.split("/instances", 1)[1].split("?")[0].lstrip("/")
        with self._api:
            if method == "POST":
                return self._insert(body)
            if method == "DELETE":
                return self._delete(name)
            if name:
                return self._describe(name)
            return {"items": [self._describe(n) for n in self.instances]}

    def calls(self, method):
        with self._lock:
            return [r for r in self.requests if r[0] == method]

    def _insert(self, body):
        import os
        name = body["name"]
        script = next(i["value"] for i in body["metadata"]["items"]
                      if i["key"] == "startup-script")
        path = os.path.join(self._dir.name, f"{name}.sh")
        with open(path, "w") as f:
            f.write(script)
        log_path = os.path.join(self._dir.name, f"{name}.log")
        with open(log_path, "w") as out:
            proc = subprocess.Popen(
                ["bash", path], env=self._env, cwd=self._dir.name,
                stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True)
        self.instances[name] = {"proc": proc, "labels": body["labels"],
                                "log": log_path}
        return {"kind": "compute#operation", "status": "RUNNING"}

    def _describe(self, name):
        inst = self.instances[name]   # KeyError: the API's 404
        if inst["proc"].poll() is not None:
            status = "TERMINATED"
        elif any(n["alive"] and n["node_id"] == inst["labels"][
                "rtpt-node-id"] for n in self._head.call("list_nodes",
                                                          timeout=5)):
            status = "RUNNING"
        else:
            status = "PROVISIONING"
        return {"name": name, "status": status, "labels": inst["labels"]}

    def _delete(self, name):
        import os
        import signal
        proc = self.instances.pop(name)["proc"]
        try:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=15)
        except ProcessLookupError:
            pass
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=15)
        return {"kind": "compute#operation", "status": "RUNNING"}

    def log_tail(self, name, n=4000):
        with open(self.instances[name]["log"]) as f:
            return f.read()[-n:]

    def close(self):
        with self._api:
            for name in list(self.instances):
                self._delete(name)
        self._head.close()
        self._dir.cleanup()


def phase_gce(model_config, engine_config, reference, stand_in_path=(),
              card="the CPU"):
    """19f. the cloud provider on the card's host: an ``Autoscaler`` (a
    head node with no card) over ``GceGpuNodeProvider`` for
    ``OPS_GCE_MACHINE`` through ``FakeCompute``. A pending
    ``OPS_GCE_BUNDLE`` drives exactly one insert; the stand-in VM's
    daemon registers under the handle's node id with the ``GPU-H100`` key
    it detected; ``model_config``'s server placed in the bundle answers
    ``reference``'s prompt with its tokens; removing the group gives one
    DELETE of that instance, the process gone, ``list_live()`` empty and
    the card's memory back. -> a summary."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import Autoscaler
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.providers.gce_gpu import GceGpuNodeProvider
    from ray_tpu_torch.runtime import instance_manager as im
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    cuda = engine_config.get("device", "cuda") == "cuda"
    prompt, want = reference
    t_phase = time.monotonic()
    if cuda:
        free_card()
        free_before, total = torch.cuda.mem_get_info()
    cluster = Cluster()
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes(1)
    fake = FakeCompute(cluster.address, stand_in_path)
    provider = GceGpuNodeProvider(
        project="phase19f", zone="us-central1-a",
        machine_type=OPS_GCE_MACHINE,
        image="projects/phase19f/global/images/h100-cuda-ray-tpu-torch",
        head_addr=cluster.address, session=cluster.session, http=fake)
    # the daemon registers this host's CPUs (its resources are null)
    shape = GceGpuNodeProvider.node_type(OPS_GCE_MACHINE,
                                         cpus=float(os.cpu_count() or 1))
    scaler = Autoscaler(cluster.address, provider, node_type=shape,
                        max_workers=1, idle_timeout_s=2.0,
                        poll_period_s=0.25).start()
    name = None
    try:
        rt.init(address=cluster.address,
                _system_config={"infeasible_grace_s": 300.0})
        assert rt.cluster_resources().get("GPU", 0.0) == 0.0
        t0 = time.monotonic()
        pg = placement_group([dict(OPS_GCE_BUNDLE)],
                             strategy="STRICT_PACK")
        (insert,), _ = poll("the insert", lambda: fake.calls("POST"))
        name = insert[2]["name"]
        ((_, handle),), _ = poll("the launch's handle",
                                 lambda: scaler._handles)
        node_id = handle.rtpu_node_id
        assert name == provider._name_for(node_id), (name, node_id)

        def registered():
            return [n for n in rt.nodes()
                    if n["Alive"] and n["NodeID"] == node_id]
        try:
            (node,), _ = poll("the stand-in VM's registration", registered,
                              timeout=120, period=0.05)
        except AssertionError:
            log(f"19f: the stand-in VM's output:\n{fake.log_tail(name)}")
            raise
        up_s = time.monotonic() - insert[3]
        assert node["Resources"].get("GPU") == 1.0, node["Resources"]
        assert node["Resources"].get("GPU-H100") == 1.0, node["Resources"]
        pg.ready(120)
        ready_s = time.monotonic() - t0
        assert pg.bundle_node(0) == node_id
        (rec,), _ = poll("the record's adoption",
                         lambda: scaler.im.records(im.RUNNING))
        assert rec.node_id == node_id
        server = rt.remote(num_gpus=1)(MainServer)
        a = server.options(placement_group=pg,
                           placement_group_bundle_index=0).remote(
            model_config, engine_config)
        where = rt.get(a.where.remote(), timeout=600)
        got = rt.get(a.one.remote(prompt, OPS_AUTOSCALE_TOKENS),
                     timeout=600)
        launches, expected, _ = rt.get(a.counts.remote(), timeout=60)
        assert where["visible"] == "0", where
        assert got == want, (got, want)
        if cuda:
            assert launches["ragged_paged_attention"] == expected, \
                (launches, expected)
        assert launches["ragged_paged_attention_reference_cuda"] == 0
        assert len(fake.calls("POST")) == 1, fake.calls("POST")
        proc = fake.instances[name]["proc"]

        t0 = time.monotonic()
        remove_placement_group(pg)
        _, drain_s = poll("the A3 node's drain", lambda: all(
            r.state == im.TERMINATED for r in scaler.im.records()),
            timeout=60)
        gone_s = wait_gone(proc.pid, timeout=30)
        deletes = fake.calls("DELETE")
        assert [d[1] for d in deletes] == [handle.name], deletes
        assert handle.name.endswith(f"/instances/{name}")
        assert provider.list_live() == {}
        assert len(fake.calls("POST")) == 1, fake.calls("POST")
        records = [[s for s, _ in r.history] for r in scaler.im.records()]
        assert records == [[im.REQUESTED, im.ALLOCATED, im.RUNNING,
                            im.DRAINING, im.TERMINATED]], records
        if cuda:
            wait_gone(where["pid"], timeout=30)
            free_card()
            free_after, _ = torch.cuda.mem_get_info()
            assert free_after >= free_before - MEMORY_RETURN_SLACK, \
                (free_before, free_after)
            memory = (f"free device memory {free_before} bytes at the "
                      f"phase's start, {free_after} after (of {total})")
        else:
            memory = "no card"
        phase_s = time.monotonic() - t_phase
        log(f"19f: GceGpuNodeProvider ({OPS_GCE_MACHINE}) over a fake "
            f"Compute API: a pending {OPS_GCE_BUNDLE} bundle drove 1 insert "
            f"({name}); the stand-in VM (its startup script under bash) "
            f"registered {up_s:.2f} s after the insert with "
            f"{ {k: v for k, v in node['Resources'].items() if k.startswith('GPU')} }"
            f", the group ready {ready_s:.2f} s after the demand; the "
            f"server at {model_config} answered {len(got)} tokens equal "
            f"to a direct engine's (worker pid {where['pid']}, process "
            f"start to __init__ {where['t_enter'] - where['t_start']:.2f} "
            f"s, built in {where['build_s']:.2f} s), ragged launches "
            f"{launches['ragged_paged_attention']} of {expected}; the "
            f"group removed -> drained and TERMINATED in {drain_s:.2f} s "
            f"with 1 DELETE, the VM's process gone {gone_s:.2f} s later, "
            f"list_live() empty; {memory}; 19f {phase_s:.1f} s; {card}")
        if cuda:
            assert phase_s <= OPS_GCE_BUDGET_S, (phase_s, OPS_GCE_BUDGET_S)
        return {"gce_up_s": up_s, "gce_ready_s": ready_s,
                "gce_drain_s": drain_s, "gce_s": phase_s,
                "gce_launches": launches["ragged_paged_attention"]}
    finally:
        rt.shutdown()
        scaler.stop()
        fake.close()
        cluster.shutdown()


# -------------------------------------------- phase 20: several cards

#: the cluster phase 20 boots: the gloo twins' CPU workers beside the
#: card workers (one CPU each); no large object crosses its store
MULTI_CPUS = 8
MULTI_STORE_BYTES = 256 << 20
#: the gloo tests' limits (tests/test_torch_sharded_train.py,
#: test_torch_seq_parallel.py, test_torch_pipeline_moe.py,
#: test_torch_sharded_optim.py), fp32 on both sides, TF32 off
PARITY_LOSS_RTOL = 2e-4
PARITY_GRAD_RTOL = 1e-5
ADAFACTOR_NORM_RTOL = 1e-4
#: the prefetching fsdp step against the plain one on the same backend
OVERLAP_RTOL = 1e-6
#: a collective's sums: 2 to 4 fp32 terms added in another order
SUM_RTOL = 1e-6
#: 20b: meshes of the collective checks by world size (every pair of
#: axes on 4 ranks shares its combined group's code), the buffer of the
#: bandwidth runs (bf16), its warm-up and timed calls
COLLECTIVE_MESHES = {2: ({"dp": 2}, {"sp": 2}),
                     4: ({"dp": 2, "tp": 2}, {"pp": 2, "fsdp": 2},
                         {"fsdp": 2, "sp": 2})}
BUS_BYTES = 256 << 20
BUS_WARMUP, BUS_ITERS = 2, 5
#: 20c: tests/test_torch_sharded_train.py's step model (flash, selective
#: remat) at widths the flash kernels take (head dim 64), its meshes by
#: world size, and the prefetching fsdp step on dp 2 x fsdp 2
SHARDED_MODEL = dict(preset="tiny", n_layers=2, dim=256, ffn_dim=512,
                     n_heads=4, n_kv_heads=2, attention="flash",
                     remat_policy="selective", dtype="float32")
SHARDED_TOKENS = (8, 32)
SHARDED_MESHES = {2: {"dp2": dict(dp=2), "fsdp2": dict(fsdp=2),
                      "tp2": dict(tp=2)},
                  4: {"dp2_fsdp2": dict(dp=2, fsdp=2),
                      "fsdp2_tp2": dict(fsdp=2, tp=2),
                      "dp2_fsdp2_overlap": dict(dp=2, fsdp=2)}}
#: 20d: Llama-3-8B, FSDP over the cards, phase 7's flash and remat,
#: Adafactor; the check at 2 of 32 layers in fp32 (two steps, the
#: first checkpointed for 20f's restore), then the numbers at 32 layers
FLAGSHIP_MODEL = dict(preset="llama3_8b", attention="flash",
                      remat_policy="selective", dtype="bfloat16")
FLAGSHIP_CHECK = dict(FLAGSHIP_MODEL, n_layers=2, dtype="float32")
FLAGSHIP_BATCH = (8, 2048)
FLAGSHIP_WARMUP, FLAGSHIP_STEPS = 2, 5
#: 20e: attention blocks (B, L, H, D; head dim 64 for the flash blocks),
#: the pipelined Llama's and Mixtral's tokens, the MoE's capacity factors
AXES_QKV = (2, 256, 4, 64)
AXES_TOKENS = (4, 16)
MOE_CAPACITY = (1.25, 8.0)
#: 20e: the ring's timing shape, one rank's block (sp 4: L 8192 in all)
RING_TIMED = (1, 2048, 24, 128)
#: 20f: the elastic program's steps, the step rank 1 exits at, the
#: grow run's steps and each step's pause (room for the grow monitor)
ELASTIC_STEPS, ELASTIC_KILL_AT = 6, 3
GROW_STEPS, GROW_PAUSE_S = 8, 1.5
#: 20f: a group whose peer stays away: the timeout the check's ranks
#: take, and the most the rank left alone may take past it (NCCL's
#: watchdog may first wait for its flight recorder's dump)
AWAY_TIMEOUT_S = 20.0
AWAY_GRACE_S = 150.0


def model_kwargs(model):
    """A model dict (``preset`` "llama3_8b" or "tiny" or none; ``dtype``
    a name) as ``LlamaConfig``'s keywords."""
    from ray_tpu_torch.models.llama import LlamaConfig
    model = dict(model)
    preset = model.pop("preset", None)
    if "dtype" in model:
        model["dtype"] = getattr(torch, model["dtype"])
    if preset is None:
        return model
    return dataclasses.asdict(getattr(LlamaConfig, preset)(**model))


def report_ranks(out, **first):
    """Every rank's ``out`` to rank 0's report (``dist.all_gather_object``),
    beside ``first``."""
    import torch.distributed as dist
    from ray_tpu_torch import train
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)
    train.report(dict(first, ranks=ranks))


def fit_ranks(loop, cfg, n, cuda, storage, name, mesh=None, failures=0,
              **scaling):
    """``TorchTrainer`` over ``n`` workers: one card each with ``cuda``
    (an NCCL group), CPU workers over gloo without. -> the Result."""
    from ray_tpu_torch import train
    from ray_tpu_torch.parallel.mesh import MeshSpec
    run = train.RunConfig(
        name=name, storage_path=str(storage),
        failure_config=train.FailureConfig(max_failures=failures))
    return train.TorchTrainer(
        loop, train_loop_config=dict(cfg, device="cuda" if cuda else "cpu"),
        scaling_config=train.ScalingConfig(
            num_workers=n, use_gpu=cuda, mesh=mesh or MeshSpec(dp=-1),
            **scaling),
        run_config=run).fit()


def gloo_twin(cuda, got, loop, cfg, n, storage, name, read):
    """The gloo CPU run of ``loop`` that a card run is held against; on the
    CPU (a rehearsal of the phase) the run is its own twin."""
    if not cuda:
        return got
    return read(fit_ranks(loop, cfg, n, False, storage, name))


def rank_setup(cfg):
    """A rank program's first lines: TF32 off, one thread on the CPU (the
    gloo tests' setting), -> the device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(cfg["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    return device


def to_numpy(t):
    return t.detach().float().cpu().numpy()


def worst_ratio(got, want, rtol):
    """max |got - want| over ``rtol`` x the largest |want| (+1e-7, the
    tests' floor): <= 1 passes."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max(initial=0.0)
                 / (rtol * np.abs(want).max(initial=0.0) + 1e-7))


def hold(what, got, want, rtol, worst):
    """Hold ``got`` to ``want`` (arrays or lists of them) at ``rtol`` of the
    largest value, or to the bit at ``rtol`` None (inf where it is not):
    the worst ratio goes into ``worst`` under ``what``, a failing array's
    position and ratio under ``worst["failed"]``; ``settle`` raises."""
    import numpy as np
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        pairs = list(zip(got, want))
    else:
        pairs = [(got, want)]
    for i, (g, w) in enumerate(pairs):
        if rtol is None:
            r = 0.0 if np.array_equal(np.asarray(g), np.asarray(w)) \
                else math.inf
        else:
            r = worst_ratio(g, w, rtol)
        if r > 1:
            worst.setdefault("failed", []).append(
                f"{what} [{i}]: {r:.3g} of {rtol or 'the bit'}")
        worst[what] = max(worst.get(what, 0.0), r)


def hold_scalar(what, got, want, rtol, worst):
    r = abs(got - want) / (rtol * abs(want))
    if r > 1:
        worst.setdefault("failed", []).append(
            f"{what}: {got} against {want} ({r:.3g} of {rtol})")
    worst[what] = max(worst.get(what, 0.0), r)


def settle(worst, what):
    """Raise with every comparison of ``worst`` past its limit."""
    assert not worst.get("failed"), f"{what}: {worst['failed']}"


def ratios(worst):
    return ", ".join(f"{k} {v:.3f}" for k, v in worst.items()
                     if k != "failed")


def skip_below(need, what):
    """Log a skip line when this machine has fewer than ``need`` cards:
    -> whether to skip."""
    have = torch.cuda.device_count()
    if have >= need:
        return False
    log(f"phase {what}: skipped, needs {need} cards, "
        f"torch.cuda.device_count() is {have}")
    return True


# ---- 20a: the NCCL group on 2 and 4 cards, teardown and re-join


def group_loop(cfg):
    """20a's rank program: what the rank sees (backend, world, its card's
    uuid and ``CUDA_VISIBLE_DEVICES``, the node ids ``global_mesh`` would
    group by), then it leaves the group and joins a new one at rank 0's
    free port in the same process, and sums its rank over it."""
    import os
    import socket
    import time

    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train import backend
    device = rank_setup(cfg)
    cuda = device.type == "cuda"
    ctx = train.get_context()
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "cards": torch.cuda.device_count() if cuda else 0,
           "uuid": str(torch.cuda.get_device_properties(0).uuid)
           if cuda else None, "nodes": backend._node_ids(),
           "pid": os.getpid()}
    port = [None]
    if ctx.get_rank() == 0:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = [s.getsockname()[1]]
        s.close()
    dist.broadcast_object_list(port, src=0)
    t0 = time.monotonic()
    backend.teardown_torch_worker()
    backend.setup_torch_worker({
        "coordinator": f"127.0.0.1:{port[0]}", "rank": ctx.get_rank(),
        "world_size": ctx.get_world_size(), "use_gpu": cuda})
    out["rejoin_s"] = time.monotonic() - t0
    x = torch.full((4,), float(ctx.get_rank() + 1), device=device)
    dist.all_reduce(x)
    out["sum"] = x.tolist()
    out["pid_after"] = os.getpid()
    report_ranks(out)


def phase_group(cuda, storage, sizes=(2, 4)):
    """20a: ``TorchTrainer`` with ``use_gpu`` over 2 and 4 workers, one
    card each: every rank in an NCCL group of the run's size (gloo on the
    CPU), one card visible to each, distinct cards, one node, then the
    re-join in the same processes."""
    out = {}
    for n in sizes:
        if cuda and skip_below(n, f"20a at {n} cards"):
            continue
        t0 = time.monotonic()
        res = fit_ranks(group_loop, {}, n, cuda, storage, f"20a-{n}")
        fit_s = time.monotonic() - t0
        ranks = res.metrics["ranks"]
        want_backend = "nccl" if cuda else "gloo"
        assert all(r["backend"] == want_backend and r["world"] == n
                   for r in ranks), ranks
        assert all(r["sum"] == [n * (n + 1) / 2] * 4 for r in ranks), ranks
        assert all(r["pid"] == r["pid_after"] for r in ranks), ranks
        assert len({tuple(r["nodes"]) for r in ranks}) == 1
        if cuda:
            assert all(r["cards"] == 1 for r in ranks), ranks
            assert len({r["uuid"] for r in ranks}) == n, ranks
            assert len({r["visible"] for r in ranks}) == n, ranks
        out[n] = ranks
        log(f"20a: {n} ranks, {want_backend}, fit {fit_s:.1f} s; cards "
            f"(CUDA_VISIBLE_DEVICES) {[r['visible'] for r in ranks]}, each "
            f"rank sees {[r['cards'] for r in ranks]}; re-joined a new "
            f"group in the same processes in "
            f"{[round(r['rejoin_s'], 2) for r in ranks]} s, its all-reduce "
            f"{ranks[0]['sum'][0]}")
    return out


# ---- 20b: every collective over every axis; bus bandwidth


COLLECTIVE_OPS = ("sum", "mean", "max", "min", "gather0", "gather1",
                  "gather_stack", "scatter0", "scatter1", "broadcast",
                  "alltoall01", "alltoall10", "alltoall_bf16_strided",
                  "shift+1", "shift-1")
#: ops whose forward moves values without adding them (equal to the bit)
MOVES = ("max", "min", "gather0", "gather1", "gather_stack", "broadcast",
         "alltoall01", "alltoall10", "alltoall_bf16_strided", "shift+1",
         "shift-1")
#: ops whose backward adds (a sum's, a gather's and a broadcast's)
SUMMED_GRADS = ("sum", "mean", "gather0", "gather1", "gather_stack",
                "broadcast")


def run_collective(op, x, mesh, axis):
    from ray_tpu_torch.parallel import collectives as C
    if op in ("sum", "mean", "max", "min"):
        return C.allreduce(x, mesh, axis, op)
    if op.startswith("gather"):
        return C.allgather(x, mesh, axis, 1 if op == "gather1" else 0,
                           tiled=op != "gather_stack")
    if op.startswith("scatter"):
        return C.reducescatter(x, mesh, axis, int(op[-1]))
    if op == "broadcast":
        return C.broadcast(x, mesh, axis, root=1)
    if op == "alltoall_bf16_strided":    # a transposed bf16 view
        return C.alltoall(x.bfloat16().t(), mesh, axis, 0, 1)
    if op.startswith("alltoall"):
        return C.alltoall(x, mesh, axis, int(op[-2]), int(op[-1]))
    return C.ppermute_shift(x, mesh, axis, int(op[len("shift"):]))


def bus_times(group, n, nbytes, device, warmup=BUS_WARMUP, iters=BUS_ITERS):
    """Median ms of each collective on ``nbytes`` of bf16 over ``group``
    (n ranks): all-reduce (in place), all-gather (the output nbytes),
    reduce-scatter (the input nbytes), all-to-all, and a shift (each rank
    sends nbytes to the next and receives as much)."""
    import statistics

    import torch.distributed as dist

    from ray_tpu_torch.parallel import collectives as C
    cuda = device.type == "cuda"
    elems = nbytes // 2
    x = torch.ones(elems, dtype=torch.bfloat16, device=device)
    part = torch.ones(elems // n, dtype=torch.bfloat16, device=device)
    y = torch.empty_like(x)
    me = dist.get_group_rank(group, dist.get_rank())

    def shift():
        ops = [dist.P2POp(dist.isend, x,
                          dist.get_global_rank(group, (me + 1) % n), group),
               dist.P2POp(dist.irecv, y,
                          dist.get_global_rank(group, (me - 1) % n), group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    ops = {"all_reduce": lambda: dist.all_reduce(x, group=group),
           "all_gather": lambda: C._gather_into(y, part, group=group),
           "reduce_scatter": lambda: C._scatter_into(part, x, group=group),
           "all_to_all": lambda: dist.all_to_all_single(y, x, group=group),
           "shift": shift}
    out = {}
    for name, fn in ops.items():
        ms = []
        for i in range(warmup + iters):
            dist.barrier(group=group)
            if cuda:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                t = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                fn()
                t = (time.perf_counter() - t0) * 1e3
            if i >= warmup:
                ms.append(t)
        out[name] = statistics.median(ms)
    return out


#: nccl-tests' bus-bandwidth factors (algbw = nbytes / time)
BUS_FACTOR = {"all_reduce": lambda n: 2 * (n - 1) / n,
              "all_gather": lambda n: (n - 1) / n,
              "reduce_scatter": lambda n: (n - 1) / n,
              "all_to_all": lambda n: (n - 1) / n,
              "shift": lambda n: 1.0}


def collectives_loop(cfg):
    """20b's rank program: on each mesh of ``cfg["meshes"]`` (built with
    its combined groups), each collective of ``parallel.collectives``
    over each axis and over the axes together, forward and the backward
    of a seeded cotangent, on seeded per-rank inputs; then the bus
    times over the whole group and over the last mesh's last axis."""
    import numpy as np
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec, axis_group, build_mesh
    device = rank_setup(cfg)
    rank, n = dist.get_rank(), dist.get_world_size()
    out = {"cases": {}, "groups": {}}
    for spec in cfg["meshes"]:
        mesh = build_mesh(MeshSpec(**spec))
        assert mesh.device_type == device.type, mesh.device_type
        tag = "·".join(f"{a}{d}" for a, d in spec.items())
        out["groups"][tag] = sorted("+".join(k) for k in mesh._rtpt_groups)
        axes = list(spec) + ([tuple(spec)] if len(spec) > 1 else [])
        for axis in axes:
            name = axis if isinstance(axis, str) else "+".join(axis)
            for k, op in enumerate(COLLECTIVE_OPS):
                rng = np.random.default_rng([rank, k])
                x = torch.tensor(rng.standard_normal((8, 8)),
                                 dtype=torch.float32, device=device)
                x.requires_grad_(op not in ("max", "min"))
                y = run_collective(op, x, mesh, axis)
                case = {"y": to_numpy(y)}
                if x.requires_grad:
                    cot = torch.tensor(rng.standard_normal(tuple(y.shape)),
                                       dtype=torch.float32, device=device)
                    (y.float() * cot).sum().backward()
                    case["dx"] = to_numpy(x.grad)
                out["cases"][f"{tag}/{name}/{op}"] = case
    if cfg.get("bus_bytes"):
        pair = axis_group(mesh, list(cfg["meshes"][-1])[-1])
        out["bus"] = {
            f"{n} ranks": bus_times(dist.group.WORLD, n, cfg["bus_bytes"],
                                    device),
            "2 ranks": bus_times(pair, 2, cfg["bus_bytes"], device)}
    report_ranks(out)


def phase_collectives(cuda, storage, sizes=(2, 4), bus_bytes=BUS_BYTES):
    """20b: ``collectives_loop`` over gloo CPU ranks, then over NCCL ranks
    on the cards: forward values and gradients equal to the bit where the
    collective moves values (gathers, shifts, all-to-alls, broadcast,
    max, min), to ``SUM_RTOL`` of the largest where it adds; the same
    combined groups; the bus bandwidth at ``bus_bytes`` of bf16 (cards
    only; the topology printed beside it)."""
    out = {}
    for n in sizes:
        if cuda and skip_below(n, f"20b at {n} cards"):
            continue
        cfg = {"meshes": COLLECTIVE_MESHES[n]}
        t0 = time.monotonic()
        got = fit_ranks(collectives_loop, dict(cfg, bus_bytes=bus_bytes),
                        n, cuda, storage, f"20b-{n}").metrics["ranks"]
        fit_s = time.monotonic() - t0
        twin = gloo_twin(cuda, got, collectives_loop, cfg, n, storage,
                         f"20b-gloo-{n}", lambda r: r.metrics["ranks"])
        worst = {}
        for r, (g, w) in enumerate(zip(got, twin)):
            assert g["groups"] == w["groups"], (g["groups"], w["groups"])
            assert set(g["cases"]) == set(w["cases"])
            for key, case in w["cases"].items():
                op = key.rsplit("/", 1)[1]
                hold(f"{op} forward", g["cases"][key]["y"], case["y"],
                     None if op in MOVES else SUM_RTOL, worst)
                if "dx" in case:
                    hold(f"{op} backward", g["cases"][key]["dx"],
                         case["dx"],
                         SUM_RTOL if op in SUMMED_GRADS else None, worst)
        bus = {}
        for group, times in got[0].get("bus", {}).items():
            k = int(group.split()[0])
            for name in times:
                ms = max(r["bus"][group][name] for r in got)
                bus[f"{name} over {group}"] = {
                    "ms": ms, "busbw_GBps": bus_bytes / (ms / 1e3) / 1e9
                    * BUS_FACTOR[name](k)}
        out[n] = {"worst": worst, "bus": bus}
        log(f"20b: {n} ranks ({'nccl' if cuda else 'gloo'} against gloo), "
            f"{len(twin[0]['cases'])} cases a rank over the meshes "
            f"{[g for g in twin[0]['groups']]} (combined groups "
            f"{twin[0]['groups']}): values moved equal to the bit (0), "
            f"sums within {SUM_RTOL} of the largest; worst ratio to each "
            f"limit: {ratios(worst)}; fit {fit_s:.1f} s")
        if bus:
            log(f"20b: bus bandwidth at {bus_bytes} bytes of bf16 (median "
                f"of {BUS_ITERS} after {BUS_WARMUP}, the slowest rank; "
                f"nccl-tests' factors): " + "; ".join(
                    f"{k} {v['ms']:.3f} ms = {v['busbw_GBps']:.1f} GB/s"
                    for k, v in bus.items()))
        settle(worst, f"20b at {n} ranks")
    return out


# ---- 20c: the sharded train step's meshes


def tree_to(tree, device):
    """A copy of a parameter tree on ``device`` (a copy on the CPU too: a
    leaf's local shard may be a view of what it was sharded from, and
    the optimizers step the shards in place)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def sharded_loop(cfg):
    """20c's rank program: tests/test_torch_sharded_train.py's program on
    each mesh of ``cfg["meshes"]`` in turn: one step's loss and every
    gradient leaf gathered whole, then three chained steps of SGD, AdamW
    and Adafactor (losses, gradient norms, the parameters after them);
    the parameters from one seed on the CPU, the tokens from a numpy
    seed, so both backends start alike."""
    import functools

    import numpy as np
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train.optim import Adafactor
    from ray_tpu_torch.train.train_step import (local_shard, param_leaves,
                                                reduce_gradients)
    device = rank_setup(cfg)
    base = tl.LlamaConfig(**model_kwargs(cfg["model"]))
    host = tl.init_params(base, seed=0, device="cpu")
    np_tokens = np.random.default_rng(0).integers(0, base.vocab_size,
                                                  cfg["tokens"])
    for name in tfa.launch_counts:
        tfa.launch_counts[name] = 0
    optimizers = {
        "sgd": lambda ps: torch.optim.SGD(ps, lr=1e-2),
        "adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-3,
                                              weight_decay=1e-4),
        "adafactor": lambda ps: Adafactor(ps, lr=1e-3)}
    out = {}
    for case, spec in cfg["meshes"].items():
        overlap = case.endswith("_overlap")
        tcfg = dataclasses.replace(base, fsdp_overlap=overlap)
        mesh = build_mesh(MeshSpec(**spec))
        specs = tl.param_specs(tcfg)
        tokens = train.shard_batch(torch.tensor(np_tokens, device=device),
                                   mesh)

        def fresh():
            return train.shard_params(tree_to(host, device), mesh, specs)

        params = fresh()
        local = {k: ({n: local_shard(t) for n, t in v.items()}
                     if isinstance(v, dict) else local_shard(v))
                 for k, v in params.items()}
        leaves = param_leaves(local)
        for t in leaves:
            t.requires_grad_(True)
        loss = tl.loss_fn(local, tokens, tcfg, mesh=mesh)
        loss.backward()
        reduce_gradients(leaves)
        res = {"loss": loss.item(), "grads": [to_numpy(DTensor.from_local(
            t.grad, mesh, t.shard_info.placements,
            run_check=False).full_tensor()) for t in leaves]}
        for opt_name in (("sgd",) if overlap else optimizers):
            params = fresh()
            init_fn, step_fn = train.make_train_step(
                functools.partial(tl.loss_fn, cfg=tcfg, mesh=mesh),
                optimizers[opt_name])
            opt = init_fn(params)
            hist = []
            for _ in range(3):
                params, opt, m = step_fn(params, opt, tokens)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            res[opt_name] = {"metrics": hist, "params": [
                to_numpy(t.full_tensor()) for t in param_leaves(params)]}
        out[case] = res
    train.report({"cases": out, "launches": dict(tfa.launch_counts)})


def phase_sharded_train(cuda, storage, sizes=(2, 4), model=SHARDED_MODEL,
                        tokens=SHARDED_TOKENS, meshes=SHARDED_MESHES):
    """20c: ``sharded_loop`` over gloo CPU ranks and over NCCL ranks on
    the cards, each mesh of ``SHARDED_MESHES``: one step's loss (rel
    ``PARITY_LOSS_RTOL``) and gathered gradients (``PARITY_GRAD_RTOL`` of
    each leaf's largest), the chained steps' losses, the first gradient
    norm, SGD's norms and parameters, Adafactor's norms (rel
    ``ADAFACTOR_NORM_RTOL``) and parameters; the prefetching fsdp step
    equal to the plain one on the same backend (``OVERLAP_RTOL``). ->
    the cards' flash launches."""
    launches = {}
    for n in sizes:
        if cuda and skip_below(n, f"20c at {n} cards"):
            continue
        cfg = {"meshes": meshes[n], "model": model, "tokens": tokens}
        t0 = time.monotonic()
        res = fit_ranks(sharded_loop, cfg, n, cuda, storage,
                        f"20c-{n}").metrics
        fit_s = time.monotonic() - t0
        twin = gloo_twin(cuda, res, sharded_loop, cfg, n, storage,
                         f"20c-gloo-{n}", lambda r: r.metrics)
        worst = {}
        for case, w in twin["cases"].items():
            g = res["cases"][case]
            hold_scalar(f"{case} loss", g["loss"], w["loss"],
                        PARITY_LOSS_RTOL, worst)
            hold(f"{case} grads", g["grads"], w["grads"], PARITY_GRAD_RTOL,
                 worst)
            for opt in ("sgd", "adamw", "adafactor"):
                if opt not in w:
                    continue
                gm, wm = g[opt]["metrics"], w[opt]["metrics"]
                for (gl, gn), (wl, wn) in zip(gm, wm):
                    hold_scalar(f"{case} {opt} losses", gl, wl,
                                PARITY_LOSS_RTOL, worst)
                hold_scalar(f"{case} {opt} first norm", gm[0][1], wm[0][1],
                            PARITY_GRAD_RTOL, worst)
                if opt in ("sgd", "adafactor"):
                    rtol = PARITY_GRAD_RTOL if opt == "sgd" \
                        else ADAFACTOR_NORM_RTOL
                    for (_, gn), (_, wn) in zip(gm, wm):
                        hold_scalar(f"{case} {opt} norms", gn, wn, rtol,
                                    worst)
                    hold(f"{case} {opt} params", g[opt]["params"],
                         w[opt]["params"], PARITY_GRAD_RTOL, worst)
            if case.endswith("_overlap"):
                plain = res["cases"][case[:-len("_overlap")]]
                hold_scalar(f"{case} loss against the plain step",
                            g["loss"], plain["loss"], OVERLAP_RTOL, worst)
                hold(f"{case} grads against the plain step", g["grads"],
                     plain["grads"], OVERLAP_RTOL, worst)
        launches[n] = res["launches"]
        log(f"20c: {n} ranks ({'nccl' if cuda else 'gloo'} against gloo), "
            f"meshes {list(meshes[n])}, flash launches on rank 0 "
            f"{res['launches']}, fit {fit_s:.1f} s; worst ratio to each "
            f"limit: {ratios(worst)}")
        settle(worst, f"20c at {n} ranks")
    return launches


# ---- 20d: the flagship, Llama-3-8B FSDP over four cards


def step_overlap(prof):
    """From a profiled step: (NCCL kernels' device ms, other kernels' ms
    (their union over streams), the NCCL ms that ran while another
    kernel did), from the device events' intervals; None without device
    events."""
    from torch.autograd import DeviceType
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and e.time_range.end > e.time_range.start]
    if not spans:
        return None
    comm = sorted((s, e) for n, s, e in spans if "nccl" in n.lower())
    comp = sorted((s, e) for n, s, e in spans if "nccl" not in n.lower())
    union = []
    for s, e in comp:
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], e)
        else:
            union.append([s, e])
    under = sum(max(0, min(e, ue) - max(s, us))
                for s, e in comm for us, ue in union)
    return (sum(e - s for s, e in comm) / 1e3,
            sum(e - s for s, e in union) / 1e3, under / 1e3)


def flagship_loop(cfg):
    """20d's rank program: Llama-3-8B widths (``cfg["model"]``), FSDP over
    the run's ranks (the mesh ``MeshSpec(fsdp=-1)``), the parameters from
    one seed made whole on each card and sharded, the tokens from one CPU
    seed, Adafactor; with a checkpoint it restores parameters and
    optimizer state first. Runs each of ``cfg["variants"]`` (a name, the
    model's changes, warm-up and timed steps) on the same parameters,
    rank 0 profiling one more step of each when ``cfg["profile"]``; the
    first ``cfg["save"]`` steps report a checkpoint. Every rank's step
    times, peak memory and flash launches go to the last report."""
    import functools
    import time as _time

    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.train import Adafactor
    device = rank_setup(cfg)
    cuda = device.type == "cuda"
    ctx = train.get_context()
    mesh = ctx.global_mesh()
    base = tl.LlamaConfig(**model_kwargs(cfg["model"]))
    whole = tl.init_params(base, seed=0, device=device)
    params = train.shard_params(whole, mesh, tl.param_specs(base))
    del whole
    if cuda:
        torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(1)
    tokens = train.shard_batch(torch.randint(
        0, base.vocab_size, tuple(cfg["batch"]), generator=g).to(device),
        mesh)
    load_s = None
    for name in tfa.launch_counts:
        tfa.launch_counts[name] = 0
    mine = {"step_s": {}, "nccl": {}}
    saved = 0
    # one step function for every variant (its optimizer holds the
    # shards), the model's changes read at each call
    current = {}
    init_fn, step_fn = train.make_train_step(
        lambda p, b: tl.loss_fn(p, b, current["cfg"], mesh=mesh),
        functools.partial(Adafactor, lr=1e-3))
    opt = init_fn(params)
    if ctx.get_checkpoint() is not None:
        t0 = _time.monotonic()
        state = ctx.get_checkpoint().load(target={"params": params,
                                                  "opt": None})
        with torch.no_grad():
            for dst, src in zip(train.param_leaves(params),
                                train.param_leaves(state["params"])):
                dst.to_local().copy_(src.to_local())
        opt.load_state_dict(state["opt"])
        del state
        load_s = _time.monotonic() - t0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for vname, changes, warmup, steps in cfg["variants"]:
        current["cfg"] = dataclasses.replace(base, **changes)
        times = []
        for i in range(warmup + steps):
            t0 = _time.monotonic()
            params, opt, m = step_fn(params, opt, tokens)
            loss = float(m["loss"])                 # waits for the card
            dt = _time.monotonic() - t0
            if i >= warmup:
                times.append(dt)
            ckpt = None
            if saved < cfg.get("save", 0):
                ckpt = {"params": params, "opt": opt.state_dict()}
                saved += 1
            train.report({"loss": loss, "variant": vname, "step_s": dt,
                          "grad_norm": float(m["grad_norm"]),
                          "load_s": load_s}, checkpoint_tree=ckpt)
        mine["step_s"][vname] = times
        if cfg.get("profile"):
            dist.barrier()
            if ctx.get_rank() == 0 and cuda:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = _time.monotonic()
                    params, opt, m = step_fn(params, opt, tokens)
                    float(m["loss"])
                    prof_s = _time.monotonic() - t0
                mine["nccl"][vname] = (step_overlap(prof), prof_s)
            else:
                params, opt, m = step_fn(params, opt, tokens)
                float(m["loss"])
    mine["launches"] = dict(tfa.launch_counts)
    mine["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    report_ranks(mine, loss=loss)


def flagship_reference_loss(model, batch, device):
    """The first step's loss of ``flagship_loop`` on one card, no mesh:
    the same parameters and tokens, the forward alone."""
    from ray_tpu_torch.models import llama as tl
    cfg = tl.LlamaConfig(**model_kwargs(model))
    params = tl.init_params(cfg, seed=0, device=device)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, tuple(batch),
                           generator=g).to(device)
    with torch.no_grad():
        loss = float(tl.loss_fn(params, tokens, cfg))
    del params
    return loss


def phase_flagship(cuda, storage, n=4, check_model=FLAGSHIP_CHECK,
                   model=FLAGSHIP_MODEL, batch=FLAGSHIP_BATCH,
                   warmup=FLAGSHIP_WARMUP, steps=FLAGSHIP_STEPS, card=""):
    """20d on ``n`` cards: the check (``check_model``, two steps, the first
    checkpointed for 20f): its first loss equal to the same tokens' loss
    from the same parameters on one card (rel ``PARITY_LOSS_RTOL``); then
    ``model`` (unless None) with the plain fsdp gathers and with the
    prefetching ones
    (``fsdp_overlap``), ``warmup`` and ``steps`` each, one more step of
    each under the profiler on rank 0: losses finite and falling, step
    ms, tokens/s, MFU per card, peak memory per card, NCCL kernels' time
    and the share of it under other kernels, the flash launches. ->
    (the check's Result, the numbers' summary)."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.mesh import MeshSpec
    if cuda and skip_below(n, f"20d at {n} cards"):
        return None, None
    device = torch.device("cuda" if cuda else "cpu")
    mesh = MeshSpec(fsdp=-1)
    t0 = time.monotonic()
    check = fit_ranks(flagship_loop, {
        "model": check_model, "batch": batch, "save": 1,
        "variants": [("check", {}, 0, 2)]}, n, cuda, storage, "20d-check",
        mesh=mesh)
    check_s = time.monotonic() - t0
    hist = steps_of(check)
    want = flagship_reference_loss(check_model, batch, device)
    if cuda:
        free_card()
    gap = abs(hist[0]["loss"] - want) / abs(want)
    assert gap <= PARITY_LOSS_RTOL, (hist[0]["loss"], want)
    ccfg = tl.LlamaConfig(**model_kwargs(check_model))
    log(f"20d check: {ccfg.n_layers} layers, dim {ccfg.dim}, fp32, "
        f"fsdp {n}, B {batch[0]} x L {batch[1]}: first loss "
        f"{hist[0]['loss']:.6f} against one card's {want:.6f} (gap "
        f"{gap:.2e} of itself, limit {PARITY_LOSS_RTOL}); second "
        f"{hist[1]['loss']:.6f}; checkpoint {check.checkpoint.path}; fit "
        f"{check_s:.1f} s")
    if model is None:
        return check, None
    t0 = time.monotonic()
    res = fit_ranks(flagship_loop, {
        "model": model, "batch": batch, "profile": True,
        "variants": [("plain", {}, warmup, steps),
                     ("prefetch", {"fsdp_overlap": True}, 1, steps)]},
        n, cuda, storage, "20d", mesh=mesh)
    fit_s = time.monotonic() - t0
    losses = [m["loss"] for m in steps_of(res)]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    ranks = res.metrics["ranks"]
    cfg = tl.LlamaConfig(**model_kwargs(model))
    B, L = batch
    per_rank = B * L // n
    summary = {"losses": losses, "fit_s": fit_s,
               "peaks": [r["peak"] for r in ranks],
               "launches": ranks[0]["launches"], "variants": {}}
    total = sum(1 + warmup + steps for warmup, steps in
                ((warmup, steps), (1, steps)))
    if cuda:
        expected = expected_flash_launches(cfg.n_layers, total)
        assert ranks[0]["launches"] == expected, (ranks[0]["launches"],
                                                  expected)
    for vname in ranks[0]["step_s"]:
        slowest = [max(r["step_s"][vname][i] for r in ranks)
                   for i in range(steps)]
        step_s = sorted(slowest)[len(slowest) // 2]
        tok_s = B * L / step_s
        mfu = tok_s / n * tl.flops_per_token(cfg, L) / BF16_FLOPS
        nccl = ranks[0]["nccl"].get(vname)
        summary["variants"][vname] = {"step_s": step_s, "tok_s": tok_s,
                                      "mfu": mfu, "nccl": nccl}
        comm = "not measured (no device events)"
        if nccl and nccl[0]:
            (comm_ms, comp_ms, under_ms), prof_s = nccl
            moved = fsdp_bytes(cfg, n, regather=vname == "plain")
            comm = (f"rank 0's profiled step {prof_s * 1e3:.1f} ms: NCCL "
                    f"kernels {comm_ms:.1f} ms, other kernels {comp_ms:.1f}"
                    f" ms, NCCL under other kernels {under_ms:.1f} ms "
                    f"({under_ms / comm_ms:.1%}); about {moved / 1e9:.1f} GB "
                    f"through each rank's links a step = "
                    f"{moved / (comm_ms / 1e3) / 1e9:.1f} GB/s over the "
                    f"NCCL kernels' time")
        log(f"20d {vname}: {cfg.n_layers} layers, {tl.num_params(cfg)} "
            f"parameters, fsdp {n}, B {B} x L {L} ({per_rank // L} x {L} a "
            f"rank): step {step_s * 1e3:.1f} ms (median of {steps} after "
            f"warm-up, the slowest rank each step), {tok_s:.0f} tokens/s, "
            f"MFU {mfu:.1%} a card of 989 TFLOP/s; {comm}; {card}")
    log(f"20d: losses {[round(x, 4) for x in losses]}; peak memory per card "
        f"{summary['peaks']} bytes; rank 0's flash launches "
        f"{ranks[0]['launches']}; fit {fit_s:.1f} s")
    if cuda:
        summary["flash_ms"] = flash_at_rank_shape(
            device, cfg, per_rank // L, L, f"fsdp {n} rank", card)
    return check, summary


def flash_at_rank_shape(device, cfg, B, L, name, card=""):
    """The three flash kernels alone at one rank's shape of ``cfg`` (B
    rows of L, GQA's kv heads repeated to the q heads, as the model
    does): 16a's checks and times, beside each kernel's bound. -> name
    -> (ms, (bound ms, bound by))."""
    shard = phase_flash_shards(device, shards={
        name: (B, cfg.n_heads, cfg.n_kv_heads)}, L=L, D=cfg.head_dim)
    out = {k: (ms, flash_bound_ms(k, B * cfg.n_heads, L, L, cfg.head_dim,
                                  True, 2))
           for k, ms in shard[name]["ms"].items()}
    log(f"20d: the flash kernels at a {name}'s shape, ms against the bound"
        " (989 TFLOP/s, 3.35 TB/s): " + ", ".join(
            f"{k} {ms:.4f} / {b[0]:.4f} ({b[1]})"
            for k, (ms, b) in out.items()) + f"; {card}")
    return out


def steps_of(result):
    """A flagship run's step reports (the last report carries the ranks'
    records only)."""
    return [m for m in result.metrics_history if "ranks" not in m]


def fsdp_bytes(cfg, n, regather):
    """The bytes each rank's gathers and reduce-scatters move in one fsdp
    step of ``cfg`` over ``n`` ranks: the fp32 layers gathered in the
    forward, again in the backward's recompute (``regather``: the plain
    path; the prefetching one keeps the gathered layers), their gradients
    reduce-scattered; the embedding gathered once and reduce-scattered."""
    from ray_tpu_torch.models.llama import num_params
    embed = cfg.vocab_size * cfg.dim
    layers = num_params(cfg) - embed - cfg.dim
    return 4 * (n - 1) / n * ((3 if regather else 2) * layers + 2 * embed)


# ---- 20e: the fused ring, Ulysses, the pipeline and ep across cards


def axes_loop(cfg):
    """20e's rank program on 4 ranks: ring attention through the fused
    ring of flash blocks at sp 4 and at dp 2 x sp 2 (``use_kernel`` True:
    the kernels on CUDA tensors, their plain versions on CPU ones),
    Ulysses at dp 2 x sp 2 (the block outputs and the gradients of a
    seeded cotangent, causal); Llama's loss and gradients with pp 2 over
    dp 2 ("full" attention: the pipeline's shift chain over P2P);
    ``moe_ffn_sharded`` on a hand-made (dp 2, ep 2) mesh, each dp row its
    own tokens (per-rank capacity buckets), and Mixtral's loss and
    gradients there. With ``cfg["ring_timed"]``, the ring's forward over
    sp 4 at that block shape in bf16, timed."""
    import importlib
    import statistics

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models import mixtral as tm
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.parallel.mesh import (MeshSpec, axis_index, axis_size,
                                             build_mesh)
    from ray_tpu_torch.parallel.moe import moe_ffn_sharded
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded
    from ray_tpu_torch.train.train_step import (local_shard, param_leaves,
                                                reduce_gradients)
    ra = importlib.import_module("ray_tpu_torch.parallel.ring_attention")
    device = rank_setup(cfg)
    rank = dist.get_rank()
    for name in tfa.launch_counts:
        tfa.launch_counts[name] = 0
    rng = np.random.default_rng(20)
    qkv, cot = (rng.standard_normal((4, *cfg["qkv"])).astype(np.float32)
                for _ in range(2))
    out = {}

    def block(a, mesh):
        """This rank's [B/dp, L/sp] block of a global array."""
        dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
        B, L = a.shape[:2]
        i, j = axis_index(mesh, "dp"), axis_index(mesh, "sp")
        return torch.tensor(a[i * B // dp:(i + 1) * B // dp,
                              j * L // sp:(j + 1) * L // sp], device=device)

    for case, spec in (("ring sp4", dict(sp=4)),
                       ("ring dp2 sp2", dict(dp=2, sp=2)),
                       ("ulysses dp2 sp2", dict(dp=2, sp=2))):
        mesh = build_mesh(MeshSpec(**spec))
        q, k, v = (block(a, mesh).requires_grad_() for a in qkv[:3])
        if case.startswith("ring"):
            o = ra.ring_attention_sharded(q, k, v, mesh, causal=True,
                                          use_kernel=True)
            out[f"{case} path"] = ra.last_ring_path()
        else:
            o = ulysses_attention_sharded(q, k, v, mesh, causal=True)
        (o.float() * block(cot[0], mesh)).sum().backward()
        out[case] = [to_numpy(t) for t in (o, q.grad, k.grad, v.grad)]

    def loss_grads(loss_fn, tree, mcfg, specs, tokens, mesh):
        params = train.shard_params(tree, mesh, specs)
        loc = {k: ({n: local_shard(t) for n, t in v.items()}
                   if isinstance(v, dict) else local_shard(v))
               for k, v in params.items()}
        leaves = param_leaves(loc)
        for t in leaves:
            t.requires_grad_(True)
        loss = loss_fn(loc, train.shard_batch(tokens, mesh), mcfg, mesh=mesh)
        loss.backward()
        reduce_gradients(leaves)
        return loss.item(), [to_numpy(DTensor.from_local(
            t.grad, mesh, t.shard_info.placements,
            run_check=False).full_tensor()) for t in leaves]

    # Llama with pp 2 x dp 2: the pipeline's shift chain
    lcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32,
                               pp_microbatches=2)
    tokens = torch.tensor(np.random.default_rng(21).integers(
        0, lcfg.vocab_size, cfg["tokens"]), device=device)
    mesh = build_mesh(MeshSpec(pp=2, dp=2))
    out["pp2 dp2"] = loss_grads(
        tl.loss_fn, tree_to(tl.init_params(lcfg, seed=0, device="cpu"),
                            device), lcfg, tl.param_specs(lcfg), tokens, mesh)

    # the MoE and Mixtral on (dp 2, ep 2)
    mesh = init_device_mesh(device.type, (2, 2), mesh_dim_names=("dp", "ep"))
    d, e = axis_index(mesh, "dp"), axis_index(mesh, "ep")
    mcfg = tm.MixtralConfig.tiny(dtype=torch.float32, remat=False)
    full = tm.init_params(mcfg, seed=0, device="cpu")
    E = mcfg.n_experts
    moe = {k: v[0] for k, v in full["layers"].items()
           if k in ("router", "w_gate", "w_in", "w_out")}
    rows = np.random.default_rng(22).standard_normal(
        (2, 64, mcfg.dim)).astype(np.float32)
    for cf in cfg["capacity"]:
        params = {k: (v if k == "router" else v[e * E // 2:(e + 1) * E // 2]
                      ).to(device, copy=True).requires_grad_()
                  for k, v in moe.items()}
        x = torch.tensor(rows[d, e * 32:(e + 1) * 32], device=device
                         ).requires_grad_()
        y = moe_ffn_sharded(params, x, mesh, capacity_factor=cf)
        (y ** 2).sum().backward()
        out[f"moe dp2 ep2 cf {cf}"] = [to_numpy(y), to_numpy(x.grad)] + [
            to_numpy(params[k].grad) for k in sorted(params)]
        with torch.no_grad():
            own = capacity_moe_reference(
                {k: v.to(device) for k, v in moe.items()}, x, cf)
        out[f"moe dp2 ep2 cf {cf} y against its own"] = worst_ratio(
            to_numpy(y), to_numpy(own), PARITY_GRAD_RTOL)
    tree = tree_to(full, device)
    for k in ("w_gate", "w_in", "w_out"):
        tree["layers"][k] = tree["layers"][k][:, e * E // 2:(e + 1) * E // 2]
    tree["layers"] = {k: v.contiguous().requires_grad_()
                      for k, v in tree["layers"].items()}
    for k in ("embed", "final_norm"):
        tree[k].requires_grad_()
    toks = torch.tensor(np.random.default_rng(23).integers(
        0, mcfg.vocab_size, (4, 16))[d * 2:(d + 1) * 2], device=device)
    loss = tm.loss_fn(tree, toks, mcfg, mesh=mesh)
    loss.backward()
    out["mixtral dp2 ep2"] = [np.float32(loss.item())] + [
        to_numpy(t.grad) for t in param_leaves(tree)]
    launches = dict(tfa.launch_counts)

    if cfg.get("ring_timed"):
        mesh = build_mesh(MeshSpec(sp=4))
        g = torch.Generator(device=device).manual_seed(24 + rank)
        q, k, v = (torch.randn(*cfg["ring_timed"], generator=g,
                               device=device).bfloat16() for _ in range(3))
        ms = []
        for i in range(7):
            dist.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ra.ring_attention_sharded(q, k, v, mesh, causal=True)
            end.record()
            end.synchronize()
            if i >= 2:
                ms.append(start.elapsed_time(end))
        out["ring ms"] = statistics.median(ms)
    out["launches"] = launches
    report_ranks(out)


def phase_axes(cuda, storage, n=4, qkv=AXES_QKV, tokens=AXES_TOKENS,
               ring_timed=RING_TIMED):
    """20e: ``axes_loop`` over gloo CPU ranks and over NCCL ranks on the
    cards, every rank's blocks against its twin's: attention outputs and
    gradients to ``PARITY_GRAD_RTOL`` of their largest value (the ring's
    path "fused" on both), the pipelined loss (rel ``PARITY_LOSS_RTOL``)
    and gradients, the MoE's outputs and gradients, Mixtral's loss and
    gradients; then, on the cards, the ring's forward at L 4 x
    ``ring_timed[1]`` over four cards against one flash call at that
    length on card 0. -> the flash launches of the cards' rank 0."""
    from ray_tpu_torch.ops import flash_attention as tfa
    if cuda and skip_below(n, "20e"):
        return None
    cfg = {"qkv": qkv, "tokens": tokens, "capacity": MOE_CAPACITY}
    t0 = time.monotonic()
    got = fit_ranks(axes_loop, dict(cfg, ring_timed=ring_timed if cuda
                                    else None), n, cuda, storage,
                    "20e").metrics["ranks"]
    fit_s = time.monotonic() - t0
    twin = gloo_twin(cuda, got, axes_loop, cfg, n, storage, "20e-gloo",
                     lambda r: r.metrics["ranks"])
    worst = {}
    for case in twin[0]:
        if case == "launches":
            continue
        if case.endswith("path"):
            assert [r[case] for r in got] == ["fused"] * n, case
            assert [r[case] for r in twin] == ["fused"] * n, case
            continue
        if case.endswith("own"):
            # each side against the plain per-rank capacity function
            for side, ranks in (("cards", got), ("gloo", twin)):
                for r in ranks:
                    worst[f"{case} ({side})"] = max(
                        worst.get(f"{case} ({side})", 0.0), r[case])
                    if r[case] > 1:
                        worst.setdefault("failed", []).append(
                            f"{case} ({side}): {r[case]:.3g}")
            continue
        for g, w in zip(got, twin):
            if case == "pp2 dp2":
                hold_scalar(f"{case} loss", g[case][0], w[case][0],
                            PARITY_LOSS_RTOL, worst)
                hold(f"{case} grads", g[case][1], w[case][1],
                     PARITY_GRAD_RTOL, worst)
            elif case.startswith("mixtral"):
                hold_scalar(f"{case} loss", float(g[case][0]),
                            float(w[case][0]), PARITY_LOSS_RTOL, worst)
                hold(f"{case} grads", g[case][1:], w[case][1:],
                     PARITY_GRAD_RTOL, worst)
            else:
                hold(case, g[case], w[case], PARITY_GRAD_RTOL, worst)
    launches = got[0]["launches"]
    if cuda:
        # the ring's blocks (sp 4: 10 forward and backward blocks a rank
        # at most, sp 2: 3) ran the kernels, never the plain versions
        assert launches["flash_attention_fwd"] > 0, launches
        assert launches["flash_attention_fwd_reference_cuda"] == 0
        assert launches["flash_attention_bwd_reference_cuda"] == 0
    line = (f"20e: 4 ranks ({'nccl' if cuda else 'gloo'} against gloo), "
            f"the ring's path {got[0]['ring sp4 path']}; rank 0's flash "
            f"launches {launches}; fit {fit_s:.1f} s; worst ratio to each "
            f"limit: {ratios(worst)}")
    log(line)
    if cuda:
        ring_ms = max(r["ring ms"] for r in got)
        B, Lr, H, D = ring_timed
        g = torch.Generator(device="cuda").manual_seed(25)
        q, k, v = (torch.randn(B, n * Lr, H, D, generator=g,
                               device="cuda").bfloat16() for _ in range(3))
        one_ms = time_ms(lambda: tfa.flash_attention(q, k, v, causal=True),
                         flush=torch.empty(256 << 20, dtype=torch.uint8,
                                           device="cuda"))
        del q, k, v
        free_card()
        log(f"20e: the ring's forward over {n} cards at B {B} x L "
            f"{n * Lr} x {H} heads x D {D} (bf16, causal; the slowest rank, "
            f"median of 5 after 2, CUDA events, the shifts included) "
            f"{ring_ms:.4f} ms against one flash call at that length on "
            f"card 0 {one_ms:.4f} ms (time_ms, L2 flushed)")
    settle(worst, "20e")
    return launches


def capacity_moe_reference(params, x, capacity_factor, top_k=2):
    """The plain function of ``moe_ffn_sharded``'s drop rule on one rank's
    tokens x [t, d] (``params``: every expert): every expert on every
    token, each (token, k) weighted by its renormalized top-k weight, or
    by 0 past the first ceil(t·k/E·factor) assignments to its expert in
    token order (tests/test_torch_pipeline_moe.py's
    ``_per_rank_capacity_moe`` in torch)."""
    import torch.nn.functional as F

    from ray_tpu_torch.parallel.moe import _expert_ffn, _routing
    E, t = params["router"].shape[1], x.shape[0]
    cap = max(1, math.ceil(t * top_k / E * capacity_factor))
    idx, w = _routing(params, x, top_k)
    onehot = F.one_hot(idx.reshape(-1), E)
    slot = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
    w = w * (slot < cap).reshape(t, top_k)
    ys = torch.stack([_expert_ffn(
        params["w_in"][e], params["w_out"][e], x,
        params["w_gate"][e] if "w_gate" in params else None)
        for e in range(E)])
    rows = torch.arange(t, device=x.device)
    return sum(w[:, k, None] * ys[idx[:, k], rows] for k in range(top_k))


# ---- 20f: checkpoints across world sizes; a lost rank; elastic grow


AWAY_RANK = """
import sys, time
import torch
import torch.distributed as dist
from ray_tpu_torch.parallel import mesh as pm
pm.GROUP_TIMEOUT_S = float(sys.argv[3])
from ray_tpu_torch.parallel.mesh import MeshSpec, axis_group
from ray_tpu_torch.train.backend import global_mesh, setup_torch_worker
rank, cuda = int(sys.argv[2]), sys.argv[5] == "cuda"
setup_torch_worker({"coordinator": sys.argv[1], "world_size": 2,
                    "rank": rank, "use_gpu": cuda})
mesh = global_mesh(MeshSpec(dp=1, fsdp=2))
group = {"world": None, "fsdp": axis_group(mesh, "fsdp")}[sys.argv[6]]
# one collective with both ranks: the group's communicator exists
dist.all_reduce(torch.ones(1, device="cuda" if cuda else "cpu"), group=group)
print("joined", flush=True)
if rank == 1:
    time.sleep(float(sys.argv[4]))
    sys.exit(0)
t0 = time.monotonic()
x = torch.ones(1, device="cuda" if cuda else "cpu")
try:
    dist.all_reduce(x, group=group)
    x.item()
    print("returned", round(time.monotonic() - t0, 2), flush=True)
except RuntimeError as e:
    print("raised", round(time.monotonic() - t0, 2), repr(e)[:200],
          flush=True)
"""


def group_timeout_check(cuda, timeout_s=AWAY_TIMEOUT_S, group="fsdp",
                        cards=(0, 1)):
    """Two ranks joined by ``setup_torch_worker`` (NCCL on cards 0 and 1,
    gloo on the CPU), ``GROUP_TIMEOUT_S`` cut to ``timeout_s``, with a
    mesh over them; rank 1 then stays away while rank 0 all-reduces over
    ``group`` ("world", or the mesh's "fsdp" group, which torch would
    give its backend's default timeout) and reads the result. Rank 0
    must end (raise, or be ended by NCCL's watchdog) within the timeout
    and ``AWAY_GRACE_S``, before its peer comes back. -> (a summary
    line, rank 0's first words after joining: "raised" and the seconds,
    on gloo)."""
    import os
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    away = timeout_s + 2 * AWAY_GRACE_S
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        if cuda:
            env["CUDA_VISIBLE_DEVICES"] = str(cards[rank])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", AWAY_RANK, f"127.0.0.1:{port}", str(rank),
             str(timeout_s), str(away), "cuda" if cuda else "cpu", group],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    t0 = time.monotonic()
    try:
        out, err = procs[0].communicate(timeout=timeout_s + AWAY_GRACE_S)
    except subprocess.TimeoutExpired:
        procs[0].kill()
        out, err = procs[0].communicate(timeout=60)
        raise AssertionError(
            f"over the {group} group rank 0 still ran {timeout_s:.0f} + "
            f"{AWAY_GRACE_S:.0f} s after its peer went away; it said "
            f"{out!r}; stderr ends {err[-3000:]!r}") from None
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=60)
    took = time.monotonic() - t0
    said = out.split("\n")
    assert said[0] == "joined", (out, err[-2000:])
    assert not any(line.startswith("returned") for line in said), out
    assert took < away, took
    watchdog = [line for line in err.splitlines()
                if "Watchdog" in line or "timed out" in line.lower()
                or "Timeout" in line][:2]
    line = (f"over the {group} group, rank 0 ended {took:.1f} s after its "
            f"peer went away (timeout {timeout_s:.0f} s; joining included),"
            f" exit code {procs[0].returncode}, it said "
            f"{said[1:2] or 'nothing'}; stderr: "
            f"{[w[:160] for w in watchdog]}")
    return line, (said[1:2] or [""])[0].split()[:2]


def elastic_loop(cfg):
    """tests/test_torch_trainer_cluster.py's elastic program on
    ``cfg["device"]``: tiny Llama replicated over dp, one row tiled over
    dp (the mean loss compares across world sizes and falls under SGD), a
    checkpoint every step; with ``cfg["kill_at"]`` rank 1 exits once,
    after that step's checkpoint is committed; with ``cfg["pause"]`` each
    step sleeps that long (room for a grow)."""
    import functools
    import os
    import time as _time

    import numpy as np

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.mesh import P
    device = rank_setup(cfg)
    ctx = train.get_context()
    mesh = ctx.global_mesh()
    n_dp = mesh.size(1)
    mcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    host = tl.init_params(mcfg, 7, device="cpu")
    specs = {k: ({n: P() for n in v} if isinstance(v, dict) else P())
             for k, v in host.items()}
    params = train.shard_params(tree_to(host, device), mesh, specs)
    restored = ctx.get_checkpoint() is not None
    if restored:
        params = ctx.get_checkpoint().load(
            target={"params": params})["params"]
    init_fn, step_fn = train.make_train_step(
        functools.partial(tl.loss_fn, cfg=mcfg, mesh=mesh),
        functools.partial(torch.optim.SGD, lr=5e-2))
    opt = init_fn(params)
    row = np.random.default_rng(3).integers(0, mcfg.vocab_size, (1, 32))
    batch = train.shard_batch(torch.tensor(np.tile(row, (n_dp, 1)),
                                           device=device), mesh,
                              spec=P("dp"))
    while ctx.step < cfg["total_steps"]:
        if (cfg.get("kill_at") is not None and ctx.get_rank() == 1
                and ctx.step == cfg["kill_at"]
                and not os.path.exists(cfg["marker"])):
            latest = ctx.ckpt_manager.latest
            deadline = _time.monotonic() + 60
            while (latest() is None or not latest().path.endswith(
                    f"_{ctx.step:08d}")) and _time.monotonic() < deadline:
                _time.sleep(0.05)
            with open(cfg["marker"], "w") as f:
                f.write(str(_time.time()))
            os._exit(1)
        params, opt, metrics = step_fn(params, opt, batch)
        train.report({"loss": float(metrics["loss"]),
                      "world_size": ctx.get_world_size(),
                      "restored": restored, "at": _time.time()},
                     checkpoint_tree={"params": params})
        if cfg.get("pause"):
            _time.sleep(cfg["pause"])


def phase_elastic(cuda, storage, check=None, away_timeout=AWAY_TIMEOUT_S,
                  shrink=True, grow=True, card=""):
    """20f: (1) 20d's checkpoint (4 cards) restored on 2, the next step's
    loss equal to the 4-card run's second (rel ``PARITY_LOSS_RTOL``); (2)
    the elastic program on 4 workers, rank 1 gone after step
    ``ELASTIC_KILL_AT``: the run resumes on 3 from the last manifest,
    starting at the next step, ``restored``, to the last step, its first
    loss below the killed step's; the seconds from the exit to the
    restarted group's first step (``phase_shrink``); (3) grow: 2 workers
    while a holder actor keeps 2 cards (2 CPUs on the CPU), the holder
    killed, the run ends on 4 (``phase_grow``); (4) a group whose peer
    stays away ends within the group's timeout, the world group and a
    mesh's (``group_timeout_check``, on two pairs of cards at once)."""
    from ray_tpu_torch.parallel.mesh import MeshSpec
    if cuda and skip_below(4, "20f"):
        return
    if check is not None:
        ranks = 2
        t0 = time.monotonic()
        res = fit_ranks(flagship_loop, {
            "model": check["model"], "batch": check["batch"],
            "variants": [("restored", {}, 0, 1)]}, ranks, cuda, storage,
            "20d-check", mesh=MeshSpec(fsdp=-1))
        fit_s = time.monotonic() - t0
        hist = steps_of(res)
        want = check["losses"][1]
        gap = abs(hist[0]["loss"] - want) / abs(want)
        assert gap <= PARITY_LOSS_RTOL, (hist[0]["loss"], want)
        assert hist[0]["load_s"] is not None, hist[0]
        log(f"20f: 20d's checkpoint from {check['ranks']} ranks restored on "
            f"{ranks} (fsdp "
            f"re-derived by the fill axis): read in {hist[0]['load_s']:.2f} "
            f"s, the next step's loss {hist[0]['loss']:.6f} against "
            f"{want:.6f} before the save (gap {gap:.2e} of itself); fit "
            f"{fit_s:.1f} s")
    if shrink:
        phase_shrink(cuda, storage)
    if grow:
        phase_grow(cuda, storage, card=card)
    if away_timeout is not None:
        # the world group on cards 0 and 1, a mesh's group on 2 and 3
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as pool:
            runs = list(pool.map(
                lambda a: group_timeout_check(cuda, away_timeout, *a),
                (("world", (0, 1)), ("fsdp", (2, 3)))))
        for line, _ in runs:
            log(f"20f: a group whose peer stays away: {line}; {card}")


def phase_shrink(cuda, storage):
    """20f (3): the elastic program on 4 workers, rank 1 gone after step
    ``ELASTIC_KILL_AT``; see ``phase_elastic``."""
    import json

    from ray_tpu_torch import train
    marker = storage / "20f-exited"
    t0 = time.monotonic()
    res = fit_ranks(elastic_loop, {
        "total_steps": ELASTIC_STEPS, "kill_at": ELASTIC_KILL_AT,
        "marker": str(marker)}, 4, cuda, storage, "20f-shrink",
        failures=2, min_workers=2, grow_poll_s=0.5, grow_cooldown_s=120.0)
    fit_s = time.monotonic() - t0
    assert res.error is None, res.error
    hist = res.metrics_history
    assert hist[0]["_step"] == ELASTIC_KILL_AT + 1, hist[0]
    assert hist[0]["restored"] is True, hist[0]
    assert res.metrics["world_size"] == 3, res.metrics
    assert hist[-1]["_step"] == ELASTIC_STEPS, hist[-1]
    killed = json.load(open(train.CheckpointManager(res.path).dir_for(
        ELASTIC_KILL_AT) + "/metrics.json"))
    assert hist[0]["loss"] < killed["loss"], (hist[0], killed)
    restart_s = hist[0]["at"] - float(marker.read_text())
    log(f"20f: rank 1 of 4 exited after step {ELASTIC_KILL_AT}; the run "
        f"resumed on {res.metrics['world_size']} "
        f"{'cards' if cuda else 'CPU ranks'} from the last manifest at step "
        f"{hist[0]['_step']} (restored), ended at step {hist[-1]['_step']}; "
        f"first loss after the restart {hist[0]['loss']:.6f} below the "
        f"killed step's {killed['loss']:.6f}; {restart_s:.1f} s from the "
        f"exit to the restarted group's first step; fit {fit_s:.1f} s")


def phase_grow(cuda, storage, grow_steps=GROW_STEPS, grow_pause=GROW_PAUSE_S,
               card=""):
    """20f (4): the elastic program grows from 2 workers to 4 once a
    holder actor gives back what it kept; see ``phase_elastic``."""
    import json

    import ray_tpu_torch as rt
    holder = rt.remote(**({"num_gpus": 2} if cuda else {"num_cpus": 2}))(
        Holder).remote()
    rt.get(holder.ready.remote(), timeout=300)
    box = {}

    def fit():
        try:
            box["result"] = fit_ranks(elastic_loop, {
                "total_steps": grow_steps, "pause": grow_pause}, 4, cuda,
                storage, "20f-grow", min_workers=2, grow_poll_s=0.5,
                grow_min_dwell_s=1.0)
        except BaseException as e:          # raised in the caller below
            box["error"] = e

    t0 = time.monotonic()
    runner = threading.Thread(target=fit, daemon=True)
    runner.start()
    grow_dir = storage / "20f-grow"
    deadline = time.monotonic() + 600
    while not any(grow_dir.glob("checkpoint_*")) and \
            time.monotonic() < deadline and runner.is_alive():
        time.sleep(0.2)
    rt.kill(holder)
    freed, freed_at = time.monotonic(), time.time()
    runner.join(900)
    assert not runner.is_alive(), "the grow run did not end"
    if "error" in box:
        raise box["error"]
    res = box["result"]
    worlds = sorted({json.load(open(p))["world_size"] for p in
                     grow_dir.glob("checkpoint_*/metrics.json")})
    assert res.metrics["world_size"] == 4, res.metrics
    assert 2 in worlds, worlds
    assert res.metrics_history[0]["restored"] is True
    log(f"20f: grow: started on 2 while a holder kept 2 "
        f"{'cards' if cuda else 'CPUs'}, the holder killed "
        f"{freed - t0:.1f} s in; world sizes in the checkpoints {worlds}, "
        f"the run ended on {res.metrics['world_size']} at step "
        f"{res.metrics_history[-1]['_step']}, resumed at step "
        f"{res.metrics_history[0]['_step']} "
        f"{res.metrics_history[0]['at'] - freed_at:.1f} s after the "
        f"holder's kill; {card}")


class Holder:
    """An actor that only holds what it was leased (20f's grow)."""

    def ready(self):
        return True


# ---- 20g: tp serving with a shard on each card; 20h: a card per trial


def phase_tp_cards(main_streams=None, main_launches=None, main_peak=None,
                   n=4, card=""):
    """20g: ``phase_tp_serving`` (17a) at tp=4 with the shards on cards
    0..3, full 8B depth, phase 4's requests: streams held to phase 4's by
    17a's rule, the ragged launches 4 x phase 4's; each card's peak
    memory, and whether the cards reach each other's memory (the
    row-split sums copy partials peer to peer). -> 17a's summary."""
    if skip_below(n, "20g"):
        return None
    devices = tuple(f"cuda:{i}" for i in range(n))
    peer = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
            for i in range(n) for j in range(n) if i != j}
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    out = phase_tp_serving(main_streams=main_streams,
                           main_launches=main_launches, main_peak=main_peak,
                           devices=devices, card=card)
    peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
    free_card()
    log(f"20g: tp={n} on {list(devices)}: peak memory per card {peaks} "
        f"bytes; peer access {peer}")
    return dict(out, peaks=peaks, peer=peer)


def trial_card():
    """What a Tune trial's worker sees of the cards, and when."""
    import os
    cards = torch.cuda.device_count()
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cards": cards, "t": time.time(),
            "uuid": str(torch.cuda.get_device_properties(0).uuid)
            if cards else None}


def phase_tune_cards(n=4, config=None, batch=TUNE_BATCH, cuda=True,
                     card=""):
    """20h: phase 13's PBT on the cluster runtime with ``n`` trials of
    ``resources_per_trial={"CPU": 1, "GPU": 1}`` at once: every trial's
    worker sees one card, the trials' cards are distinct, all ran at
    the same time (each trial's first report before any trial's last).
    Without ``cuda`` (a rehearsal) the trials hold a CPU each."""
    import os
    import shutil
    import tempfile

    from ray_tpu_torch import tune
    if cuda and skip_below(n, "20h"):
        return None
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_cards_")
    scheduler = recording_pbt(
        perturbation_interval=TUNE_INTERVAL, quantile_fraction=0.5,
        hyperparam_mutations={"lr": tune.loguniform(1e-4, 3e-3)}, seed=0)
    t0 = time.monotonic()
    try:
        grid = tune.Tuner(
            tune_trainable(torch.device("cuda" if cuda else "cpu"),
                           config or TUNE_CONFIG, batch, [],
                           extra=trial_card),
            param_space={"lr": tune.grid_search(list(TUNE_LRS[:n]))},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        scheduler=scheduler,
                                        max_concurrent_trials=n),
            run_config=tune.TuneRunConfig(
                storage_path=storage,
                resources_per_trial={"CPU": 1, "GPU": 1} if cuda
                else {"CPU": 1})).fit()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    fit_s = time.monotonic() - t0
    assert not grid.errors, [t.error for t in grid.errors]
    reports = [r for t in grid.trials for r in t.results]
    uuids = {r["uuid"] for r in reports}
    if cuda:
        assert all(r["cards"] == 1 for r in reports), reports
        assert len(uuids) == n, uuids
    firsts = [t.results[0]["t"] for t in grid.trials]
    lasts = [t.results[-1]["t"] for t in grid.trials]
    assert max(firsts) < min(lasts), (firsts, lasts)
    log(f"20h: PBT, {n} trials at once: each worker saw "
        f"{sorted({r['cards'] for r in reports})} card, {len(uuids)} distinct "
        f"cards "
        f"({sorted({r['visible'] for r in reports})}); every first report "
        f"{max(firsts) - min(firsts):.1f} s apart at most, before the "
        f"first trial's last ({min(lasts) - max(firsts):.1f} s later); "
        f"{len(scheduler.exploits)} exploits; fit {fit_s:.1f} s; {card}")
    return {"fit_s": fit_s, "exploits": len(scheduler.exploits)}


def phase_multicard(main_streams=None, main_launches=None, main_peak=None,
                    card=""):
    """Phase 20: the sharded paths on several cards (20a-20f through
    ``TorchTrainer`` on one cluster, 20g in this process, 20h Tune on the
    cluster); each sub-phase logs a skip line below the cards it needs.
    -> the flash launches of 20c-20e and the ragged launches of 20g."""
    import tempfile

    import ray_tpu_torch as rt
    t_phase = time.monotonic()
    cards = torch.cuda.device_count()
    launches = {"flash": [], "ragged": 0}
    if cards < 2:
        for what, need in (("20a-20c", 2), ("20d-20h", 4)):
            skip_below(need, what)
        return launches
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60).stdout
    log("20: nvidia-smi topo -m\n" + topo.rstrip())
    storage = Path(tempfile.mkdtemp(prefix="phase20-"))
    free_card()
    rt.init(num_cpus=MULTI_CPUS, num_gpus=cards, _system_config={
        "object_store_memory_bytes": MULTI_STORE_BYTES})
    try:
        phase_group(True, storage)
        phase_collectives(True, storage)
        launches["flash"] += list(phase_sharded_train(True,
                                                      storage).values())
        check, numbers = phase_flagship(True, storage, card=card)
        if numbers is not None:
            launches["flash"].append(numbers["launches"])
        axes = phase_axes(True, storage)
        if axes is not None:
            launches["flash"].append(axes)
        phase_elastic(True, storage, check=None if check is None else {
            "model": FLAGSHIP_CHECK, "batch": FLAGSHIP_BATCH, "ranks": 4,
            "losses": [m["loss"] for m in steps_of(check)]}, card=card)
        phase_tune_cards(card=card)
    finally:
        rt.shutdown()
    tp = phase_tp_cards(main_streams, main_launches, main_peak, card=card)
    if tp is not None:
        launches["ragged"] = tp["launches"]
    log(f"phase 20: {time.monotonic() - t_phase:.1f} s; {card}")
    return launches


# ---------------------------------- phase 21: the engine under pressure

#: below this top-2 logit margin of the bf16 forward (at the context where
#: two streams part) a stream over int8 pools may part from the bf16
#: pool's, and a copied, re-admitted or recomputed stream from the same
#: request's uncontended run: int8 rounds each K/V element to within 1/254
#: of its (token, head) row's largest magnitude, about four times bf16's
#: relative rounding (2^-9) on a typical element, so the int8 pools' logit
#: noise is taken as four times tp's floor (TP_MARGIN_FLOOR, 2^-5); a
#: recompute re-prefills through the prefill tiles what the first run
#: wrote through decode rows (another order of summation, bf16 noise,
#: under the same floor). Besides it, a margin under twice the logits'
#: bf16 noise at that step passes, as in 17a.
INT8_MARGIN_FLOOR = 2.0 ** -3
#: the int8 pool's page count at phase 4's pool bytes over the bf16 page
#: count: the JAX package's capacity claim (tests/test_llm.py
#: test_int8_kv_capacity_ratio); at head dim 128 it is 256 / 130
INT8_CAPACITY_RATIO = 1.9
#: 21c: a pool the wave fits in (74 pages at most), whose free pages after
#: it (127 - the 62 it publishes) cannot take the long prompt's 94
EVICT_PAGES = 128
EVICT_PROMPT = 1500
#: 21d: a pool the wave is admitted into (66 pages with headroom) and
#: whose decode outgrows it (up to 74 pages); the schedule does not depend
#: on the tokens (no EOS), so it is the same on every card: 3 preemptions,
#: no sequence at PREEMPT_CAP (69 pages would drive one there, 70 preempt
#: once, 71 not at all)
PREEMPT_PAGES = 68
#: tokens of 21b's copy-on-write request and 21c's long request
PRESSURE_TOKENS = 16


def int8_pages_at_bytes(cfg, pages, page_size):
    """The int8 pool's page count in the bytes of a ``cfg.dtype`` pool of
    ``pages`` pages -> (int8 pages, bytes a page of each)."""
    from ray_tpu_torch.llm.cache import make_kv_cache

    def page_bytes(kv_dtype):
        pool = make_kv_cache(cfg, 1, page_size, kv_dtype=kv_dtype,
                             device="meta")
        return sum(t.numel() * t.element_size() for t in pool.values())
    fp, q8 = page_bytes(None), page_bytes("int8")
    return pages * fp // q8, fp, q8


def hold_streams(what, pairs, params, cfg, floor=INT8_MARGIN_FLOOR):
    """Each (prompt, got, want) of ``pairs``: ``got`` equal to ``want`` up
    to their first parting, where the top-2 margin of the plain forward on
    ``params`` at want's context must sit under max(``floor``, twice the
    logits' bf16 noise) (``margin_and_noise``). -> (tokens compared equal,
    tokens in all, [(pair, step, margin, noise)] at each parting)."""
    compared, total, parted = 0, 0, []
    for j, (prompt, got, want) in enumerate(pairs):
        assert len(got) == len(want), (what, j, got, want)
        total += len(want)
        step = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                    None)
        if step is None:
            compared += len(want)
            continue
        compared += step
        margin, noise = margin_and_noise(params, cfg, prompt + want[:step])
        log(f"{what}: stream {j} parts at step {step} of {len(want)}: bf16 "
            f"top-2 margin {margin:.5f}, bf16 noise of the logits "
            f"{noise:.5f}, limit {max(floor, 2 * noise):.5f}")
        assert margin < max(floor, 2 * noise), \
            f"{what}: stream {j} parts at a clear margin {margin}"
        parted.append((j, step, margin, noise))
    return compared, total, parted


def engine_launches_expected(eng, since=None):
    """The ragged launches an engine's run makes (since the stats
    ``since``): one per layer per ragged step (decode_chunk steps a decode
    dispatch), as phase 4 counts."""
    s, b = eng.stats, since or {}
    return eng.cfg.n_layers * (
        s["ragged_dispatches"] - b.get("ragged_dispatches", 0)
        + eng.decode_chunk * (s["decode_dispatches"]
                              - b.get("decode_dispatches", 0)))


def counted_run(eng, requests, launches):
    """Send (prompt, max_tokens) ``requests`` to ``eng`` at once (held to
    one admission step, ``admit_together``) and step it until they finish,
    the launch counters set to 0 before and read after: each must be the
    engine's step count (``engine_launches_expected``, int8 pools counted
    apart), the plain version never on CUDA tensors; the ragged launches
    are added to ``launches["ragged"]``. -> the streams, in order."""
    from ray_tpu_torch.ops import paged_attention as tpa
    for name in tpa.launch_counts:
        tpa.launch_counts[name] = 0
    since = dict(eng.stats)
    admit_together(eng, len(requests))
    rids = [eng.add_request(p, n) for p, n in requests]
    done = {}
    deadline = time.monotonic() + 600
    while not all(r in done for r in rids):
        assert time.monotonic() < deadline, "requests never finished"
        done.update(eng.step())
    got = dict(tpa.launch_counts)
    n = engine_launches_expected(eng, since)
    assert got["ragged_paged_attention"] == n, (got, n)
    assert got["ragged_paged_attention_int8"] == (
        n if eng.kv_dtype == "int8" else 0), got
    assert got["ragged_paged_attention_reference_cuda"] == 0, got
    launches["ragged"] += n
    return [done[r] for r in rids]


def cached_pages(eng, prompt):
    """The pages the engine's prefix cache holds for ``prompt``'s leading
    whole blocks, read without touching its counts or references."""
    from ray_tpu_torch.llm.cache import hash_token_blocks
    pages = []
    for h in hash_token_blocks(prompt, eng.page_size, eng.prefix.kv_tag):
        page = eng.prefix._pages.get(h)
        if page is None:
            break
        pages.append(page)
    return pages


def live_pool_check(eng, prompts, seed=21):
    """21a: the ragged kernel against its plain version on the engine's own
    pools (quantized by the engine on write when int8), every layer, on one
    mixed batch of the engine's geometry: a decode row over the cached
    pages of each prompt that has any, at their length, and a prefill row
    of up to a chunk ending there for the two longest; q from ``seed``.
    Each (token, head) within KERNEL_RTOL of its row's scale (phase 3's
    ``tolerance_ratios``), padding 0. -> (worst ratio, max abs error)."""
    from ray_tpu_torch.ops import paged_attention as tpa
    dev, cfg, ps = eng.device, eng.cfg, eng.page_size
    B, C = eng.max_batch, eng.prefill_chunk
    R, T = eng.ragged_rows, eng.ragged_tokens
    lists = [p for p in (cached_pages(eng, pr) for pr in prompts) if p]
    assert len(lists) >= 2, "the run published too few pages"
    pt = torch.zeros(R, eng.max_pages_per_seq, dtype=torch.int32)
    qs, ql, kl = (torch.zeros(R, dtype=torch.int32) for _ in range(3))
    for r, pages in enumerate(lists[:B]):
        pt[r, :len(pages)] = torch.tensor(pages)
        qs[r], ql[r], kl[r] = r, 1, len(pages) * ps
    t0 = B
    longest = sorted(lists, key=len, reverse=True)[:R - B]
    for j, pages in enumerate(longest):
        L = len(pages) * ps
        n = min(C, L)
        pt[B + j, :len(pages)] = torch.tensor(pages)
        qs[B + j], ql[B + j], kl[B + j] = t0, n, L
        t0 += n
    pt, qs, ql, kl = (x.to(dev) for x in (pt, qs, ql, kl))
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(T, cfg.n_heads, cfg.head_dim, generator=g,
                    device=dev).to(cfg.dtype)
    owned = torch.zeros(T, dtype=torch.bool, device=dev)
    for s0, n in zip(qs.tolist(), ql.tolist()):
        owned[s0:s0 + n] = True
    hints = dict(decode_rows=B, max_q_len=C)
    worst, err = 0.0, 0.0
    for i in range(cfg.n_layers):
        pools = {k: v[i] for k, v in eng.kv.items()}
        sc = dict(k_scale=pools.get("k_scale"), v_scale=pools.get("v_scale"))
        got = tpa.ragged_paged_attention(q, pools["k"], pools["v"], pt, qs,
                                         ql, kl, **sc, **hints)
        ref = tpa.ragged_paged_attention_reference(
            q, pools["k"], pools["v"], pt, qs, ql, kl, **sc, **hints)
        assert torch.isfinite(got).all(), f"layer {i}: non-finite output"
        assert bool((got[~owned] == 0).all()), f"layer {i}: padding not 0"
        worst = max(worst, tolerance_ratios(got, ref)[owned].max().item())
        err = max(err, (got.float() - ref.float()).abs().max().item())
    log(f"21a: the ragged kernel on the engine's live {eng.kv_dtype} pools, "
        f"{cfg.n_layers} layers, rows of kv {kl.tolist()} (q_len "
        f"{ql.tolist()}): worst {worst:.3f} x the tolerance (KERNEL_RTOL "
        f"2^-7 of each row's scale), max_abs_err {err:.3e}")
    assert worst <= 1, f"live pools: kernel vs plain at {worst} x the limit"
    return worst, err


def phase_int8_serving(params, main_streams, main_launches,
                       model_config=None, engine_config=None):
    """21a: phase 4's server and requests (``MainServer``: the wave
    admitted at one step, then the prefix hit, and the hit again under the
    profiler, as phase 4 sends it) on phase 4's weights with an int8 pool
    in the bytes of phase 4's bf16 pool (the page counts and their ratio
    printed, the ratio at least INT8_CAPACITY_RATIO): its ragged launches
    all on int8 pools and equal to the engine's step count; each stream
    equal to phase 4's up to a parting under ``hold_streams``' rule, most
    of the wave's tokens compared; then the kernel on the engine's live
    pools (``live_pool_check``). -> {"streams", "launches", "pages",
    "live_err"}."""
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    from ray_tpu_torch.ops import paged_attention as tpa
    model_config = model_config or MAIN_MODEL
    engine_config = engine_config or MAIN_ENGINE
    cfg = model_config_from_dict(model_config)
    ps, pages = engine_config["page_size"], engine_config["total_pages"]
    pages8, fp_page, q8_page = int8_pages_at_bytes(cfg, pages, ps)
    ratio = pages8 / pages
    log(f"21a: {pages} {str(cfg.dtype).removeprefix('torch.')} pages of "
        f"{fp_page} bytes = {pages * fp_page} bytes; int8 pages of "
        f"{q8_page} bytes (scales included) in those bytes: {pages8} "
        f"({pages8 * q8_page} bytes), {ratio:.4f} x the pages")
    assert ratio >= INT8_CAPACITY_RATIO, ratio
    here = MainServer(model_config, dict(engine_config, kv_dtype="int8",
                                         total_pages=pages8, params=params))
    srv, eng = here.srv, here.srv.engine
    assert eng.kv["k"].dtype == torch.int8 and len(eng.kv) == 4
    reqs, hit_req = main_requests(cfg.vocab_size, eng.prefill_chunk)
    try:
        t0 = time.monotonic()
        streams = here.answer()
        wave_hit_s = time.monotonic() - t0
        hit_s = streams["e2e_s"][len(reqs)]
        again, busy = profile_device(lambda: srv(hit_req), eng.device,
                                     hit_s * 1e3, focus=("ragged",))
        assert again["token_ids"] == streams["hit"]
        srv.check_health()
    finally:
        srv.shutdown()
    launches = dict(tpa.launch_counts)
    expected = engine_launches_expected(eng)
    n8 = launches["ragged_paged_attention_int8"]
    log(f"21a: wave and hit in {wave_hit_s:.2f} s (phase 4: wave "
        f"{main_streams.get('wave_s', float('nan')):.2f} s, hit "
        f"{main_streams.get('hit_ms', float('nan')):.1f} ms), the hit alone "
        f"{hit_s * 1e3:.1f} ms; the same request under the profiler: "
        f"{busy}")
    log(f"21a: ragged launches {launches['ragged_paged_attention']}, on "
        f"int8 pools {n8}, expected n_layers x (ragged dispatches + "
        f"decode_chunk x decode dispatches) = {expected}; phase 4's "
        f"{main_launches}")
    assert n8 == launches["ragged_paged_attention"] == expected, \
        (launches, expected)
    assert launches["ragged_paged_attention_reference_cuda"] == 0
    prompts = [p for _, p, _ in reqs] + [hit_req["prompt_ids"]]
    live = live_pool_check(eng, prompts)
    del here, srv, eng
    pairs = list(zip(prompts, streams["wave"] + [streams["hit"]],
                     main_streams["wave"] + [main_streams["hit"]]))
    compared, total, parted = hold_streams(
        "21a int8 against phase 4's bf16", pairs[:len(reqs)], params, cfg)
    hc, ht, _ = hold_streams("21a int8 against phase 4's bf16 (the hit)",
                             pairs[len(reqs):], params, cfg)
    log(f"21a: int8 streams against phase 4's bf16 streams: {compared} of "
        f"the wave's {total} tokens compared equal before a parting "
        f"({len(parted)} of {len(reqs)} streams part), the hit {hc} of "
        f"{ht}")
    assert 2 * compared > total, (compared, total)
    return {"streams": streams, "launches": n8, "pages": pages8,
            "live_err": live[1]}


def phase_cow(params, cfg, engine_config, launches):
    """21b: after the request that publishes phase 4's 256-token prefix
    (16 whole pages), a request whose prompt is exactly that prefix: the
    match caps at 255 tokens, so the engine copies the last shared page
    (``copy_page``) and recomputes its slot 15. ``cow_copies`` rises by
    one; right after the copy the two pages are equal in every layer
    (pages, and scales of int8 pools), and after the request their slots
    0-14 still are, bit for bit; the stream equals, under
    ``hold_streams``' rule, the same prompt's on an engine with
    ``prefix_cache=False``. -> the stream."""
    from ray_tpu_torch.llm.engine import InferenceEngine
    reqs, _ = main_requests(cfg.vocab_size, engine_config["prefill_chunk"])
    publisher, n_pub = reqs[1][1], reqs[1][2]
    prefix = publisher[:256]
    eng = InferenceEngine(cfg, params, **engine_config)
    counted_run(eng, [(publisher, n_pub)], launches)
    copies = []
    inner = eng._fns.copy_page

    def copy_page(kv, src, dst):
        out = inner(kv, src, dst)
        copies.append((src, dst, all(torch.equal(t[:, dst], t[:, src])
                                     for t in kv.values())))
        return out
    eng._fns.copy_page = copy_page
    cow0, cached0 = eng.stats["cow_copies"], eng.stats["cached_tokens"]
    (got,) = counted_run(eng, [(prefix, PRESSURE_TOKENS)], launches)
    assert eng.stats["cow_copies"] == cow0 + 1, eng.stats
    assert eng.stats["cached_tokens"] - cached0 == len(prefix) - 1
    assert len(copies) == 1 and copies[0][2], copies
    src, dst, _ = copies[0]
    assert src == cached_pages(eng, prefix)[-1], (src, dst)
    slots = all(torch.equal(t[:, dst, :, :15], t[:, src, :, :15])
                for t in eng.kv.values())
    assert slots, "the copy's slots 0-14 moved"
    leaves = sorted(eng.kv)
    del eng
    ref = InferenceEngine(cfg, params, **dict(engine_config,
                                              prefix_cache=False))
    (want,) = counted_run(ref, [(prefix, PRESSURE_TOKENS)], launches)
    del ref
    kv = kv_label(cfg, engine_config)
    compared, total, parted = hold_streams(
        f"21b {kv} COW against no prefix cache", [(prefix, got, want)],
        params, cfg)
    log(f"21b ({kv} pools, {engine_config['total_pages']} pages): "
        f"cow_copies +1 (page {src} -> {dst}), the copy equal to its source "
        f"in all {cfg.n_layers} layers ({', '.join(leaves)}) and its slots "
        f"0-14 still after the request; the stream against prefix_cache="
        f"False: {compared} of {total} tokens equal"
        + (f", parts at step {parted[0][1]}" if parted else ""))
    return got


def kv_label(cfg, engine_config):
    """The pool's storage: "int8", or the model's dtype."""
    return "int8" if engine_config.get("kv_dtype") == "int8" else \
        str(cfg.dtype).removeprefix("torch.")


def phase_evict(params, cfg, engine_config, wave, launches):
    """21c: phase 4's wave on a pool of EVICT_PAGES, then a prompt of
    EVICT_PROMPT tokens that only fits once the wave's unreferenced cached
    pages are evicted: ``prefix.evictions`` rises; its stream equals the
    same request's on the full pool, and the wave's streams the
    uncontended ``wave``'s, under ``hold_streams``' rule."""
    from ray_tpu_torch.llm.engine import InferenceEngine
    reqs, _ = main_requests(cfg.vocab_size, engine_config["prefill_chunk"])
    long = _prompt(7, EVICT_PROMPT, cfg.vocab_size)
    kv = kv_label(cfg, engine_config)
    eng = InferenceEngine(cfg, params, **dict(engine_config,
                                              total_pages=EVICT_PAGES))
    got_wave = counted_run(eng, [(p, n) for _, p, n in reqs], launches)
    free, cached = eng.allocator.num_free, eng.prefix.num_evictable
    need = -(-(len(long) + 1) // eng.page_size)
    assert need > free, (need, free)
    ev0 = eng.prefix.evictions
    (got,) = counted_run(eng, [(long, PRESSURE_TOKENS)], launches)
    evictions = eng.prefix.evictions - ev0
    assert evictions >= need - free >= 1, (evictions, need, free)
    del eng
    ref = InferenceEngine(cfg, params, **engine_config)
    (want,) = counted_run(ref, [(long, PRESSURE_TOKENS)], launches)
    del ref
    c, t, parted = hold_streams(f"21c {kv} long prompt after evictions",
                                [(long, got, want)], params, cfg)
    wc, wt, wparted = hold_streams(
        f"21c {kv} wave on {EVICT_PAGES} pages",
        [(p, a, b) for (_, p, _), a, b in zip(reqs, got_wave, wave)],
        params, cfg)
    log(f"21c ({kv} pools, {EVICT_PAGES} pages): after the wave {free} "
        f"pages free and {cached} cached and unreferenced; the "
        f"{len(long)}-token prompt needs {need}: {evictions} evictions, its "
        f"stream against the {engine_config['total_pages']}-page pool's: "
        f"{c} of {t} tokens equal; the wave against the uncontended run: "
        f"{wc} of {wt} ({len(wparted)} streams part)")
    return evictions


def phase_preempt(params, cfg, engine_config, wave, launches):
    """21d: phase 4's wave on a pool of PREEMPT_PAGES, which its decode
    outgrows: ``preemptions`` at least 1, no request finished "evict"
    (``PREEMPT_CAP``), the flight recorder's records holding each preempt
    and a stall before it, the ``llm_preemptions_total`` gauge equal to
    the stat after a forced update, every stream equal to the uncontended
    ``wave``'s under ``hold_streams``' rule. Pages a preemption or an
    eviction frees go to another sequence only in the host code of a
    later step, after the readback that ended the dispatch which read
    them, and every dispatch runs on the one stream in order, so no freed
    page is written before its last reader has run (a stream that read a
    page rewritten early would part at a clear margin)."""
    from ray_tpu_torch.llm.engine import InferenceEngine
    from ray_tpu_torch.util import metrics
    reqs, _ = main_requests(cfg.vocab_size, engine_config["prefill_chunk"])
    kv = kv_label(cfg, engine_config)
    eng = InferenceEngine(cfg, params, **dict(engine_config,
                                              total_pages=PREEMPT_PAGES))
    rids0 = set(eng.request_log._records) if eng.request_log else set()
    got = counted_run(eng, [(p, n) for _, p, n in reqs], launches)
    n_pre = eng.stats["preemptions"]
    assert n_pre >= 1, eng.stats
    recs = [r for rid, r in eng.request_log._records.items()
            if rid not in rids0]
    reasons = [r.finish_reason for r in recs]
    assert "evict" not in reasons and len(recs) == len(reqs), reasons
    assert sum(len(r.preempt_ts) for r in recs) == n_pre
    assert all(r.stalls >= len(r.preempt_ts) for r in recs)
    eng._update_metrics(force=True)
    gauge = metrics.snapshot()["llm_preemptions_total"]["values"][()]
    assert gauge == n_pre, (gauge, n_pre)
    del eng
    c, t, parted = hold_streams(
        f"21d {kv} wave with preemptions",
        [(p, a, b) for (_, p, _), a, b in zip(reqs, got, wave)], params, cfg)
    log(f"21d ({kv} pools, {PREEMPT_PAGES} pages): {n_pre} preemptions "
        f"(per request {[len(r.preempt_ts) for r in recs]}, stalls "
        f"{[r.stalls for r in recs]}), finish reasons {reasons}, gauge "
        f"llm_preemptions_total {gauge}; the wave against the uncontended "
        f"run: {c} of {t} tokens equal ({len(parted)} streams part)")
    return n_pre


def phase_pressure(main_streams, main_launches, model_config=None,
                   engine_config=None, card=""):
    """Phase 21: the engine under memory pressure at Llama-3-8B widths,
    all 32 layers, phase 4's weights drawn once from seed 0 and handed to
    every engine (``InferenceEngine(cfg, params)``, no copy): 21a int8
    pools at phase 4's traffic (``phase_int8_serving``); then for bf16
    and int8 pools 21b copy-on-write (``phase_cow``), 21c eviction
    (``phase_evict``), 21d recompute preemption (``phase_preempt``); 21e
    phase 17a's tp=2 server on one card with int8 pools, held against
    21a's streams by TP_MARGIN_FLOOR's rule, its launches twice 21a's.
    Nothing is cut. -> {"launches": the ragged launches of the phase's
    engines, "max_abs_err": the live-pool check's}."""
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    from ray_tpu_torch.models.llama import init_params
    t_phase = time.monotonic()
    model_config = model_config or MAIN_MODEL
    engine_config = dict(engine_config or MAIN_ENGINE)
    engine_config.setdefault("prefill_chunk", 512)
    cfg = model_config_from_dict(model_config)
    t0 = time.monotonic()
    params = init_params(cfg, engine_config["seed"],
                         engine_config.get("device", "cuda"))
    log(f"21: {cfg.n_layers} layers dim {cfg.dim}, weights drawn once from "
        f"seed {engine_config['seed']} in {time.monotonic() - t0:.1f} s")
    a = phase_int8_serving(params, main_streams, main_launches,
                           model_config, engine_config)
    launches = {"ragged": a["launches"]}
    waves = {"model": main_streams["wave"], "int8": a["streams"]["wave"]}
    for kv, pages in (("model", engine_config["total_pages"]),
                      ("int8", a["pages"])):
        ec = dict(engine_config, kv_dtype=kv, total_pages=pages)
        phase_cow(params, cfg, ec, launches)
        phase_evict(params, cfg, ec, waves[kv], launches)
        phase_preempt(params, cfg, ec, waves[kv], launches)
        free_card()
    on_card = engine_config.get("device", "cuda") == "cuda"
    tp = phase_tp_serving(
        model_config, dict(engine_config, kv_dtype="int8",
                           total_pages=a["pages"]),
        main_streams=a["streams"], main_launches=a["launches"],
        devices=TP_DEVICES if on_card else ("cpu", "cpu"), card=card,
        params=params, ref="21a")
    launches["ragged"] += tp["launches"]
    del params
    log(f"phase 21: {time.monotonic() - t_phase:.1f} s, ragged launches "
        f"{launches['ragged']} (21a {a['launches']}, 21e "
        f"{tp['launches']}); {card}")
    return {"launches": launches["ragged"], "max_abs_err": a["live_err"]}



# ---------------------- phase 22: the runtime's failures with card workers

#: phase 22's clusters: telemetry periods short enough that a reading
#: lands within a second or two, the stack sampler on, and an arena no
#: large object of 22a crosses
FAULTS_CONFIG = {"metrics_export_period_s": 1.0, "hw_sampler_period_s": 0.5,
                 "profile_enabled": True,
                 "object_store_memory_bytes": 256 << 20}
FAULTS_CPUS = 4
#: 22a: the named detached server, and the actor that waits for its card
SURVIVOR_NAME = "faults-llm8b"
PENDING_NAME = "faults-pending"
#: the bounds phase 22 holds the runtime to, in seconds: the restarted
#: head's node re-registration; a card lease placed after its holder ended;
#: a card's memory returned, and its GPU back in the head's books, after
#: its worker's end
REREGISTER_BOUND_S = 30.0
LEASE_BOUND_S = 60.0
MEMORY_BOUND_S = 30.0
#: 22d: the worker's gpu_memory_used_bytes must reach the head within this
#: many export periods of the engine's construction; the burst capture of
#: the serving worker, and the top frames (by cumulative samples) of its
#: engine thread that must name a step function
GAUGE_PERIODS = 3
BURST = {"seconds": 1.0, "hz": 99.0}
PROFILE_TOP = 12
STEP_FUNCTIONS = ("ragged_step", "ragged_decode_loop", "decode_loop")
#: 22b: the seed of the flash output's q, k, v; the arena holds 2.5 of its
#: outputs ("under three")
FAULT_FLASH_SEED = 22
#: 22c: the per-worker cap above the card worker's host RSS measured in
#: 22b, and the ballast a hog holds beyond the cap
OOM_HEADROOM_BYTES = 1 << 30
OOM_BALLAST_BYTES = 512 << 20
#: 22e: tests/test_train_straggler.py's program: rank 1's report sleeps
#: this long; each rank's step sleeps the fast time, then runs flash
#: forward and backward at STRAGGLER_QKV (B, L, H, D), for run_s
STRAGGLER_SLEEP_S = 0.4
STRAGGLER_FAST_S = 0.05
STRAGGLER_RUN_S = 6.0
STRAGGLER_QKV = (1, 256, 8, 128)


def rss_bytes():
    """This process's resident set, from /proc."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def fault_record(path, **fields):
    """Append one JSON line for this card task execution to ``path``: the
    fields, its pid, runtime worker id, CUDA_VISIBLE_DEVICES and RSS."""
    import os
    import ray_tpu_torch as rt
    fields.update(pid=os.getpid(), rss=rss_bytes(),
                  worker=rt.get_runtime_context().worker_id.hex(),
                  visible=os.environ.get("CUDA_VISIBLE_DEVICES"))
    with open(path, "a") as f:
        f.write(json.dumps(fields) + "\n")


def read_records(path):
    """The lines ``fault_record`` appended to ``path``, in order."""
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except FileNotFoundError:
        return []


def fault_flash_inputs(shape, dtype, device):
    """q, k, v [B, L, H, D] of ``shape`` (B, H, L, D) from FAULT_FLASH_SEED
    on ``device``: the same values in every process of one device type."""
    B, H, L, D = shape
    g = torch.Generator(device=device).manual_seed(FAULT_FLASH_SEED)
    return [torch.randn(B, L, H, D, generator=g, device=device).to(dtype)
            for _ in range(3)]


def card_flash(shape, dtype, device, record, what):
    """In a card worker: the flash forward on ``fault_flash_inputs``, one
    line in ``record`` (its launches counted from before the call, the RSS
    after the kernel library's load and the launch); -> {"o", "lse"} on
    the device (they cross as host bytes)."""
    from ray_tpu_torch.ops import flash_attention as tfa
    dev = torch.device(device)
    before = dict(tfa.launch_counts)
    q, k, v = fault_flash_inputs(shape, dtype, dev)
    o, lse = tfa.flash_attention_block(q, k, v, causal=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    fault_record(record, what=what, device=dev.type,
                 name=torch.cuda.get_device_name(0) if dev.type == "cuda"
                 else "cpu",
                 launches={n: tfa.launch_counts[n] - before[n]
                           for n in before})
    return {"o": o, "lse": lse}


def card_digest(x, device):
    """In a card worker: ``x`` through the card and back: -> the sha256 of
    its bytes and the device it visited."""
    y = x.to(torch.device(device))
    return tensor_digest(y), str(y.device)


def card_hog(shape, dtype, device, record, ballast_bytes, marker=None):
    """In a card worker: the flash forward, then ``ballast_bytes`` of host
    memory held for a minute (the memory monitor kills the worker before).
    With ``marker``, only the attempt that finds no marker file hogs (it
    leaves one): a retry returns the flash output."""
    import os

    import numpy as np
    hog = marker is None or not os.path.exists(marker)
    if marker is not None and hog:
        open(marker, "w").close()
    out = card_flash(shape, dtype, device, record, "hog" if hog else "retry")
    if not hog:
        return out
    ballast = np.ones(ballast_bytes // 8)
    time.sleep(60)
    return int(ballast.nbytes)


class CardHog:
    """22c's actor (``num_gpus=1, max_restarts=1``): ``hog`` is
    ``card_hog`` in the actor's worker."""

    def __init__(self, shape, dtype, device, record):
        self.args = (shape, dtype, device, record)

    def pid(self):
        import os
        return os.getpid()

    def hog(self, ballast_bytes):
        return card_hog(*self.args, ballast_bytes)


def flash_against_plain(out, shape, dtype, device, qkv=None):
    """A card task's {"o", "lse"} against the plain flash forward on the
    same inputs on ``device`` (``qkv``, else ``fault_flash_inputs``),
    flash's per-row limit: -> the worst ratio."""
    from ray_tpu_torch.ops import flash_attention as tfa
    q, k, v = (t.to(device) for t in qkv) if qkv is not None \
        else fault_flash_inputs(shape, dtype, device)
    B, H, L, D = shape
    o_ref, lse_ref = tfa._fwd_reference(tfa._bhl(q), tfa._bhl(k),
                                        tfa._bhl(v), True, D ** -0.5)
    o = tfa._bhl(out["o"].to(device))
    ratio = flash_ratios(o, o_ref).max().item()
    lse_err = (out["lse"].to(device).reshape(B * H, L) - lse_ref) \
        .abs().max().item()
    assert torch.isfinite(o).all() and ratio <= 1, ratio
    assert lse_err <= LSE_ATOL, lse_err
    return ratio


def same_output(a, b):
    """Two {"o", "lse"} equal to the bit."""
    return all(same_bytes(a[n].cpu(), b[n]) for n in ("o", "lse"))


def wait_alive_nodes(address, n, timeout):
    """Wait until the head at ``address`` lists ``n`` live nodes: -> the
    seconds it took."""
    from ray_tpu_torch.runtime.protocol import RpcClient, RpcError
    c = RpcClient(address, name="faults-probe")

    def alive():
        try:
            return sum(x["alive"] for x in c.call("list_nodes",
                                                  timeout=2)) >= n
        except RpcError:
            return False

    try:
        return poll(f"{n} live nodes at {address}", alive, timeout,
                    period=0.05)[1]
    finally:
        c.close()


class LineTap:
    """A write-through tap on a text stream that keeps the lines holding
    ``needle`` (22d reads the driver's stdout)."""

    def __init__(self, stream, needle):
        self.stream, self.needle, self.lines = stream, needle, []

    def write(self, text):
        self.lines += [ln for ln in text.splitlines() if self.needle in ln]
        return self.stream.write(text)

    def __getattr__(self, name):
        return getattr(self.stream, name)


def stop_procs(*procs):
    """Terminate daemons this phase started, and wait for their end."""
    for proc in procs:
        if proc is None or proc.poll() is not None:
            continue
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def free_memory(cuda):
    """The card's free bytes (``mem_get_info``), or None off the card."""
    return torch.cuda.mem_get_info()[0] if cuda else None


def memory_back(cuda, before):
    """Wait until the card's free memory is back within
    MEMORY_RETURN_SLACK of ``before``: -> (free bytes, seconds)."""
    if not cuda:
        return None, 0.0
    return poll("the card's memory back",
                 lambda: (f := free_memory(True))
                 >= before - MEMORY_RETURN_SLACK and f,
                 MEMORY_BOUND_S)


def phase_head_restart(model_config=None, engine_config=None,
                       main_streams=None, num_gpus=None, card=""):
    """22a and 22d: phase 4's server (``MainServer``, ``num_gpus=1``,
    named and detached) behind a head started with a persist path
    (``start_head``) and a node told of its card, the driver connected by
    address. 22d, while it answers phase 4's requests under one ambient
    trace: the worker's ``gpu_memory_used_bytes`` reaches the head within
    GAUGE_PERIODS export periods of the engine's construction and agrees
    with the worker's own ``memory_allocated`` at a quiet point, a print in
    the actor reaches the driver with its pid, the timeline holds the
    methods' spans under that trace, and a burst capture of the worker
    names a step function among its engine thread's top frames. 22a: the
    head SIGKILLed and restarted at its address on the same persist path;
    the node re-registers and hands the actor over; ``get_actor`` resolves
    it and it answers phase 4's requests again (its prefix cache dropped
    first) with its streams phase 4's and its ragged launches the engine's
    steps; a second ``num_gpus=1`` actor stays pending while the survivor
    lives, and after its kill gets the card within LEASE_BOUND_S, the card's
    memory back. -> {"launches": the survivor's ragged launches}."""
    import os
    import signal
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.config import GlobalConfig, reset_to_defaults
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.runtime.cluster_backend import start_head, start_node
    from ray_tpu_torch.util import stack_profiler as sp
    from ray_tpu_torch.util import state as state_api
    from ray_tpu_torch.util import trace_context
    model_config = model_config or MAIN_MODEL
    engine_config = engine_config or MAIN_ENGINE
    cuda = engine_config.get("device", "cuda") == "cuda"
    t_phase = time.monotonic()
    period = FAULTS_CONFIG["metrics_export_period_s"]
    tmp = Path(tempfile.mkdtemp(prefix="phase22a-"))
    persist = str(tmp / "head.pkl")
    session = "faults" + os.urandom(3).hex()
    resources = {"CPU": float(FAULTS_CPUS)}
    gpus = node_cards(cuda, num_gpus)
    if gpus is not None:
        resources["GPU"] = float(gpus)
    # the daemons take this process's settings: a fresh table, as init()
    # makes, with phase 22's over it (the restarted head reads the table
    # init() leaves, the same)
    reset_to_defaults()
    GlobalConfig.apply(FAULTS_CONFIG)
    head, address = start_head(session, persist_path=persist)
    node = start_node(address, session, resources=resources)
    port = int(address.rsplit(":", 1)[1])
    head2 = None
    out = {}
    try:
        wait_alive_nodes(address, 1, REREGISTER_BOUND_S)
        rt.init(address=address, _system_config=FAULTS_CONFIG)
        backend = global_worker.backend
        assert rt.cluster_resources().get("GPU") == 1.0, \
            rt.cluster_resources()
        free_before = free_memory(cuda)
        server_cls = rt.remote(num_gpus=1)(MainServer)
        t0 = time.monotonic()
        a = server_cls.options(name=SURVIVOR_NAME,
                               lifetime="detached").remote(
            model_config, engine_config)
        where = rt.get(a.where.remote(), timeout=600)
        built = time.time()
        create_s = time.monotonic() - t0
        ident = rt.get(a.identity.remote(), timeout=60)
        wid12 = ident["worker"][:12]
        log(f"22a: the server actor built in {create_s:.2f} s (its "
            f"construction {where['build_s']:.2f} s), pid {where['pid']}, "
            f"CUDA_VISIBLE_DEVICES {where['visible']!r}; head pid "
            f"{head.pid}, node pid {node.pid}, persist path {persist}")
        assert where["visible"] == "0", where

        # 22d: the hw gauge from the serving worker
        def gauge(since):
            for s in backend.head.call("timeseries_dump", {
                    "metric": "gpu_memory_used_bytes"}, timeout=10):
                if s["tags"].get("worker") == wid12:
                    pts = [p for p in s["points"] if p[0] >= since]
                    if pts:
                        return pts[-1]
            return None

        if cuda:
            _, gauge_s = poll(
                "the worker's gpu_memory_used_bytes at the head",
                lambda: gauge(built - period), GAUGE_PERIODS * period,
                period=0.05)
            log(f"22d: the serving worker's gpu_memory_used_bytes reached "
                f"the head {gauge_s:.2f} s after its construction returned "
                f"(bound {GAUGE_PERIODS} export periods of {period} s)")
        # 22d: a print, the method spans under one trace, a burst capture
        trace_id = trace_context.new_trace_id()
        token = trace_context.activate(trace_id, trace_context.new_span_id())
        marker = f"faults-22d-{os.urandom(4).hex()}"
        tap = LineTap(sys.stdout, marker)
        sys.stdout = tap
        try:
            rt.get(a.say.remote(marker), timeout=60)
            pending = a.answer.remote()
            time.sleep(0.3)
            burst = backend.head.call("profiles_record", dict(
                BURST, role="worker", worker=wid12),
                timeout=BURST["seconds"] + 60)
            got = rt.get(pending, timeout=900)
            launches, expected, _ = rt.get(a.counts.remote(), timeout=60)
            poll("the actor's print at the driver", lambda: tap.lines, 30)
        finally:
            sys.stdout = tap.stream
            trace_context.deactivate(token)
        check_streams(got, main_streams)
        assert launches["ragged_paged_attention"] == (
            expected if cuda else 0), (launches, expected)
        assert launches["ragged_paged_attention_reference_cuda"] == 0

        # 23b: the worker's first llm.ragged_step record at the head, read
        # before the head's kill (its store dies with it)
        def first_step():
            dump = backend.head.call("compiles_dump", {
                "callable": "llm.ragged_step", "worker": wid12}, timeout=10)
            return next((r for r in dump["records"] if r["nth"] == 1),
                        None)

        out["ragged_record"], _ = poll(
            "the server worker's first llm.ragged_step record at the head",
            first_step, 10 * period, period=0.1)
        line = tap.lines[0]
        assert f"pid={where['pid']}" in line, line

        def traced():
            names = {e["name"].rsplit(".", 1)[-1] for e in backend.head.call(
                "timeline_dump", timeout=10)
                if e.get("trace_id") == trace_id}
            return names if {"say", "answer", "counts"} <= names else None

        spans, spans_s = poll(
            "the server's method spans under the driver's trace", traced,
            10 * period)
        procs = [p for p in burst["procs"] if p.get("worker") == wid12]
        assert procs and procs[0]["samples"] > 0, burst["procs"]
        stacks = procs[0]["stacks"]
        engine = {s: n for s, n in stacks.items() if "llm.engine" in s}
        top = sorted(sp.top_frames(engine, 0), key=lambda r: -r["cum"])
        names = [r["frame"].rsplit(":", 1)[0] for r in top[:PROFILE_TOP]]
        assert any(n.startswith("ray_tpu_torch.llm.") and n.rsplit(
            ".", 1)[-1] in STEP_FUNCTIONS for n in names), names
        # the gauge against the worker's own reading at a quiet point
        quiet = rt.get(a.identity.remote(), timeout=60)
        if cuda:
            t_quiet = time.time()
            (_, value), _ = poll(
                "a gauge sample after the quiet reading",
                lambda: gauge(t_quiet), GAUGE_PERIODS * period,
                period=0.05)
            assert int(value) == quiet["allocated"], (value, quiet)
            log(f"22d: at a quiet point the gauge reads {int(value)} bytes, "
                f"equal to the worker's torch.cuda.memory_allocated")
        log(f"22d: the actor's print reached the driver as {line!r}; "
            f"spans {sorted(spans)} under trace {trace_id[:12]} "
            f"({spans_s:.2f} s after the calls); the burst capture "
            f"({BURST['seconds']} s at {BURST['hz']} Hz) of the serving "
            f"worker: {procs[0]['samples']} samples, its engine thread's "
            f"top frames by cumulative samples {names[:6]}; {card}")
        log(f"22a: before the restart the worker's {len(got['wave']) + 1} "
            f"streams " + ("equal phase 4's" if main_streams is not None
                           else "(no phase 4 run to compare)")
            + f", ragged launches {launches['ragged_paged_attention']} = "
            f"the engine's steps")

        # 22a: SIGKILL the head mid-workload, restart it on its address
        t_kill = time.monotonic()
        os.kill(head.pid, signal.SIGKILL)
        head.wait(timeout=30)
        head2, address2 = start_head(session, port=port,
                                     persist_path=persist)
        assert address2 == address, (address, address2)
        wait_alive_nodes(address, 1, REREGISTER_BOUND_S)
        reg_s = time.monotonic() - t_kill

        def resolve():
            try:
                b = rt.get_actor(SURVIVOR_NAME)
                return b, rt.get(b.identity.remote(), timeout=10)
            except Exception:  # noqa: BLE001 — not yet reconciled
                return None

        (b, ident_b), _ = poll("get_actor through the new head", resolve,
                               REREGISTER_BOUND_S, period=0.2)
        answer_s = time.monotonic() - t_kill
        assert ident_b["pid"] == where["pid"], (ident_b, where)
        freed = rt.get(b.forget_prefixes.remote(), timeout=60)
        got2 = rt.get(b.answer.remote(), timeout=900)
        launches2, expected2, _ = rt.get(b.counts.remote(), timeout=60)
        check_streams(got2, main_streams)
        assert got2["wave"] == got["wave"] and got2["hit"] == got["hit"], \
            "the restart moved a token"
        assert launches2["ragged_paged_attention"] == (
            expected2 if cuda else 0), (launches2, expected2)
        assert launches2["ragged_paged_attention_reference_cuda"] == 0
        assert expected2 == 2 * expected, (expected, expected2)
        log(f"22a: head SIGKILLed and restarted on {address}: the node "
            f"re-registered {reg_s:.2f} s after the kill, get_actor "
            f"resolved the same worker (pid {ident_b['pid']}) and it "
            f"answered {answer_s:.2f} s after the kill; {freed} cached "
            f"pages dropped, then its streams equal its first wave's"
            + (" and phase 4's" if main_streams is not None else "")
            + f", ragged launches {launches2['ragged_paged_attention']} = "
            f"the engine's steps ({expected2})")

        # 22a: the card's books survived the re-registration
        assert rt.available_resources().get("GPU", 0.0) == 0.0, \
            rt.available_resources()
        c = server_cls.options(name=PENDING_NAME).remote(
            model_config, engine_config, build=False)
        placed = c.where.remote()
        ready, _ = rt.wait([placed], timeout=3)
        state = {x["actor_id"]: x["state"] for x in
                 state_api.list_actors()}.get(c.actor_id.hex())
        assert ready == [] and state != "ALIVE", (ready, state)
        t0 = time.monotonic()
        rt.kill(b)
        gone_s = wait_gone(where["pid"])
        c_where = rt.get(placed, timeout=LEASE_BOUND_S)
        lease_s = time.monotonic() - t0
        free_after, mem_s = memory_back(cuda, free_before)
        assert c_where["visible"] == "0" and c_where["pid"] != where["pid"]
        log(f"22a: a second num_gpus=1 actor stayed pending while the "
            f"survivor lived (GPU available 0.0, its state {state}); "
            f"kill -> the survivor's process gone in {gone_s:.2f} s, the "
            f"pending actor placed "
            f"{lease_s:.2f} s after the kill (bound {LEASE_BOUND_S} s, pid "
            f"{c_where['pid']})" + (
                f"; free device memory {free_before} bytes before the "
                f"survivor, {free_after} {mem_s:.2f} s after its end"
                if cuda else "") + f"; {card}")
        rt.kill(c)
        out.update(launches=launches2["ragged_paged_attention"],
                   restart_s=(reg_s, answer_s))
    finally:
        rt.shutdown()
        stop_procs(node, head2, head)
    log(f"22a, 22d: {time.monotonic() - t_phase:.1f} s")
    return out


def phase_lineage_spill(shape=FLASH_SHAPE, dtype=torch.bfloat16,
                        device="cuda", num_gpus=None, card=""):
    """22b: a ``num_gpus=1`` task draws q, k, v from a seeded generator on
    the card and returns the flash forward's (o, lse) (``card_flash``);
    its primary copy deleted out of band, ``get`` rebuilds it by running
    the task again, equal to the bit, and it agrees with the plain version;
    then in an arena of 2.5 outputs, puts spill and read back equal, a
    spilled output crosses a card task as its argument, and a spilled task
    output whose spill file is deleted rebuilds through lineage. Every
    execution launches the flash forward once. -> {"launches": the flash
    forward's, "rss": the card workers' largest host RSS}."""
    import os
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.config import GlobalConfig
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.runtime.object_plane import spill_file_path
    t_phase = time.monotonic()
    cuda = device == "cuda"
    B, H, L, D = shape
    out_bytes = B * L * H * D * dtype.itemsize
    arena = 5 * out_bytes // 2
    record = str(Path(tempfile.mkdtemp(prefix="phase22b-")) / "runs.jsonl")
    rt.init(num_cpus=FAULTS_CPUS, num_gpus=node_cards(cuda, num_gpus),
            _system_config={"object_store_memory_bytes": arena})
    try:
        store = global_worker.backend.object_plane.store
        make = rt.remote(num_gpus=1)(card_flash)
        t0 = time.monotonic()
        ref_a = make.remote(shape, dtype, device, record, "first")
        # a private copy: a view of the arena would pin the object there
        first = {n: t.clone() for n, t in rt.get(ref_a, timeout=600).items()}
        first_s = time.monotonic() - t0
        ratio = flash_against_plain(first, shape, dtype, device)
        key = ref_a.id().binary()
        assert store.contains(key), "the output is not in the arena"
        store.release(key)
        store.delete(key)
        assert not store.contains(key)
        t0 = time.monotonic()
        rebuilt = rt.get(ref_a, timeout=600)
        rebuild_s = time.monotonic() - t0
        assert same_output(rebuilt, first), "the rebuilt output differs"
        del rebuilt
        # puts past the arena spill to disk and read back equal
        puts = [rt.put(first["o"]) for _ in range(2)]
        for ref in puts:
            assert same_bytes(first["o"], rt.get(ref, timeout=120))

        def spilled(refs):
            return [r for r in refs if os.path.exists(spill_file_path(
                GlobalConfig.session_dir, store.name, r.id().hex()))]

        assert spilled(puts), "no put spilled past the arena"
        digest = rt.remote(num_gpus=1)(card_digest)
        got, visited = rt.get(digest.remote(spilled(puts)[0], device),
                              timeout=600)
        want, _ = card_digest(first["o"], "cpu")
        assert got == want and visited.startswith(device), (got, visited)
        # a task's output spilled, its spill file lost
        ref_b = make.remote(shape, dtype, device, record, "into spill")
        rt.wait([ref_b], timeout=600)
        lost = spilled([ref_b, ref_a])
        assert lost, "no task output spilled past the arena"
        victim = lost[0]
        os.unlink(spill_file_path(GlobalConfig.session_dir, store.name,
                                  victim.id().hex()))
        vkey = victim.id().binary()
        if store.contains(vkey):
            store.release(vkey)
            store.delete(vkey)
        t0 = time.monotonic()
        back = rt.get(victim, timeout=600)
        spill_rebuild_s = time.monotonic() - t0
        assert same_output(back, first), "the rebuilt spilled output differs"
        del back, puts, ref_a, ref_b, victim
    finally:
        rt.shutdown()
    runs = read_records(record)
    assert [r["what"] for r in runs] == [
        "first", "first", "into spill", "into spill"], runs
    for r in runs:
        assert r["launches"]["flash_attention_fwd"] == (1 if cuda else 0), r
        assert r["launches"]["flash_attention_fwd_reference_cuda"] == 0, r
        assert r["visible"] == "0" and r["device"] == device, r
    launches = sum(r["launches"]["flash_attention_fwd"] for r in runs)
    rss = max(r["rss"] for r in runs)
    log(f"22b: the flash output (o {out_bytes} bytes, lse "
        f"{B * H * L * 4} bytes) of a card task in {first_s:.2f} s, within "
        f"{ratio:.3f} of flash's limit of the plain version; its primary "
        f"deleted, get rebuilt it by running the task again in "
        f"{rebuild_s:.2f} s, equal to the bit; in an arena of {arena} "
        f"bytes two puts of o read back equal, a spilled one crossed a card "
        f"task equal (sha256 {got[:12]}), and a spilled task output whose "
        f"file was deleted rebuilt in {spill_rebuild_s:.2f} s, equal to the "
        f"bit; {len(runs)} executions, {launches} flash launches; the card "
        f"workers' host RSS {min(r['rss'] for r in runs)}-{rss} bytes "
        f"after the kernel; phase 22b {time.monotonic() - t_phase:.1f} s; "
        f"{card}")
    return {"launches": launches, "rss": rss}


def phase_oom(baseline_rss, shape=FLASH_SHAPE, dtype=torch.bfloat16,
              device="cuda", num_gpus=None, headroom=OOM_HEADROOM_BYTES,
              ballast=OOM_BALLAST_BYTES, card=""):
    """22c: the per-worker cap ``baseline_rss`` (a card worker's host RSS
    after its kernel, from 22b) plus ``headroom``, polled every 100 ms; a
    ``num_gpus=1`` task launches the flash forward and then holds host
    ballast past the cap: with ``max_retries=0`` it raises
    ``OutOfMemoryError``, the card's memory returns and ``GPU`` is back in
    the head's books within their bounds, and the journal has the victim's
    ``worker_death`` with its cause; with ``max_retries=2`` the frugal
    retry runs on the card and agrees with the plain version; an actor
    (``max_restarts=1``) killed so gives ``worker_death`` then
    ``actor_restarting`` under one trace id. -> {"launches": the flash
    forward's}."""
    import os
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.exceptions import OutOfMemoryError
    t_phase = time.monotonic()
    cuda = device == "cuda"
    limit = baseline_rss + headroom
    hold = headroom + ballast
    tmp = Path(tempfile.mkdtemp(prefix="phase22c-"))
    record = str(tmp / "runs.jsonl")
    rt.init(num_cpus=FAULTS_CPUS, num_gpus=node_cards(cuda, num_gpus),
            _system_config={
                "object_store_memory_bytes":
                    FAULTS_CONFIG["object_store_memory_bytes"],
                "worker_memory_limit_bytes": limit,
                "memory_monitor_refresh_ms": 100})
    try:
        head = global_worker.backend.head
        gpus = rt.cluster_resources()["GPU"]
        free_before = free_memory(cuda)
        hog = rt.remote(num_gpus=1, max_retries=0)(card_hog)
        t0 = time.monotonic()
        try:
            rt.get(hog.remote(shape, dtype, device, record, hold),
                   timeout=300)
        except OutOfMemoryError as e:
            kill_s = time.monotonic() - t0
            cause = str(e).splitlines()[0]
        else:
            raise AssertionError("the hog was not OOM-killed")
        victim = read_records(record)[-1]
        gone_s = wait_gone(victim["pid"])
        free_after, mem_s = memory_back(cuda, free_before)
        _, res_s = poll(
            "GPU back in the head's books",
            lambda: rt.available_resources().get("GPU") == gpus,
            LEASE_BOUND_S)

        def death(worker):
            return next((e for e in head.call(
                "events_dump", {"type": "worker_death"}, timeout=10)
                if e.get("worker_id", "").startswith(worker)), None)

        wd, _ = poll("the victim's worker_death",
                      lambda: death(victim["worker"]), 30)
        assert "oom" in wd["exit_cause"], wd
        log(f"22c: the cap {limit} bytes (the card worker's RSS "
            f"{baseline_rss} + {headroom}), polled every 100 ms; the hog "
            f"(flash, then {hold} bytes of ballast) raised "
            f"OutOfMemoryError {kill_s:.2f} s after submission ({cause!r}); "
            f"its process gone {gone_s:.2f} s later, GPU back in the books "
            f"after {res_s:.2f} s (bound {LEASE_BOUND_S} s)" + (
                f", free device memory {free_before} bytes before, "
                f"{free_after} {mem_s:.2f} s after its end (bound "
                f"{MEMORY_BOUND_S} s)" if cuda else "")
            + f"; the journal's worker_death: {wd['exit_cause']!r}")
        # the frugal retry waits for the freed card and completes on it
        flaky = rt.remote(num_gpus=1, max_retries=2)(card_hog)
        t0 = time.monotonic()
        out = rt.get(flaky.remote(shape, dtype, device, record, hold,
                                  marker=str(tmp / "attempted")),
                     timeout=600)
        retry_s = time.monotonic() - t0
        ratio = flash_against_plain(out, shape, dtype, device)
        del out
        # an actor killed so: worker_death, then actor_restarting
        actor = rt.remote(num_gpus=1, max_restarts=1)(CardHog).remote(
            shape, dtype, device, record)
        rt.get(actor.pid.remote(), timeout=600)
        call = actor.hog.remote(hold)
        with contextlib.suppress(Exception):
            rt.get(call, timeout=60)
        hog_line = read_records(record)[-1]
        aid = actor.actor_id.hex()

        def pair():
            evs = head.call("events_dump", timeout=10)
            wds = [e for e in evs if e["type"] == "worker_death"
                   and e.get("worker_id", "").startswith(hog_line["worker"])]
            ars = [e for e in evs if e["type"] == "actor_restarting"
                   and e.get("actor_id") == aid]
            return (wds[-1], ars[-1]) if wds and ars else None

        (awd, aar), _ = poll("the actor's death -> restart pair", pair, 60)
        assert "oom" in awd["exit_cause"], awd
        assert awd["trace_id"] and awd["trace_id"] == aar["trace_id"], \
            (awd, aar)
        assert awd["seq"] < aar["seq"], (awd, aar)
        rt.kill(actor)
    finally:
        rt.shutdown()
    runs = read_records(record)
    assert [r["what"] for r in runs] == ["hog", "hog", "retry", "hog"], runs
    retry = runs[2]
    assert retry["pid"] != runs[1]["pid"] and retry["visible"] == "0" \
        and retry["device"] == device, runs
    for r in runs:
        assert r["launches"]["flash_attention_fwd"] == (1 if cuda else 0), r
        assert r["launches"]["flash_attention_fwd_reference_cuda"] == 0, r
    launches = sum(r["launches"]["flash_attention_fwd"] for r in runs)
    log(f"22c: with max_retries=2 the retry ran on the card "
        f"({retry['name']}, pid {retry['pid']}) {retry_s:.2f} s after "
        f"submission, within {ratio:.3f} of flash's limit of the plain "
        f"version; the actor's worker_death ({awd['exit_cause']!r}, seq "
        f"{awd['seq']}) then actor_restarting (seq {aar['seq']}) under "
        f"trace {awd['trace_id'][:12]}; {len(runs)} executions, "
        f"{launches} flash launches; phase 22c "
        f"{time.monotonic() - t_phase:.1f} s; {card}")
    return {"launches": launches}


def straggler_loop(cfg):
    """tests/test_train_straggler.py's rank program with a card's work in
    each step: sleep, then flash forward and backward; every report
    carries this rank's flash launches."""
    import time as _t

    from ray_tpu_torch import train
    from ray_tpu_torch.ops import flash_attention as tfa
    dev = torch.device(cfg["device"])
    g = torch.Generator(device=dev).manual_seed(train.get_context()
                                                .get_rank())
    q, k, v = (torch.randn(*cfg["qkv"], generator=g, device=dev)
               .to(cfg["dtype"]).requires_grad_() for _ in range(3))
    before = dict(tfa.launch_counts)
    t0 = _t.monotonic()
    steps = 0
    while _t.monotonic() - t0 < cfg["run_s"]:
        _t.sleep(cfg["fast_s"])
        tfa.flash_attention(q, k, v, causal=True).float().sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        steps += 1
        # rank 1's report() entry hits the armed sleep
        train.report({"ok": 1, "steps": steps, "launches": {
            n: tfa.launch_counts[n] - before[n] for n in before}})


def phase_straggler(cuda=True, card=""):
    """22e: tests/test_train_straggler.py's program through
    ``TorchTrainer`` on two cards, a rank a card (``use_gpu``; two gloo
    CPU ranks with ``cuda`` False), rank 1's reports slowed through the
    port's fault point: one ``train_straggler`` event naming host 1 under
    the run's trace, the skew gauges putting host 1 behind by about the
    sleep, and each step's flash kernels on rank 0. -> {"flash": rank 0's
    launches by kernel} (None below two cards)."""
    import os
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.util import fault_injector as fi
    if cuda and skip_below(2, "22e"):
        return None
    t_phase = time.monotonic()
    os.environ[fi.ENV_VAR] = f"train.report.rank1=sleep:{STRAGGLER_SLEEP_S}"
    rt.init(num_cpus=FAULTS_CPUS, num_gpus=2 if cuda else 0,
            _system_config={
                "object_store_memory_bytes":
                    FAULTS_CONFIG["object_store_memory_bytes"],
                "metrics_export_period_s": 0.2})
    try:
        result = train.TorchTrainer(
            straggler_loop,
            train_loop_config={"run_s": STRAGGLER_RUN_S,
                               "fast_s": STRAGGLER_FAST_S,
                               "qkv": STRAGGLER_QKV,
                               "device": "cuda" if cuda else "cpu",
                               "dtype": torch.bfloat16 if cuda
                               else torch.float32},
            scaling_config=train.ScalingConfig(num_workers=2,
                                               use_gpu=cuda),
            run_config=train.RunConfig(
                name="straggle",
                storage_path=tempfile.mkdtemp(prefix="phase22e-"))).fit()
        assert result.error is None, result.error
        assert result.metrics["_step"] > 20, result.metrics
        head = global_worker.backend.head
        evs, _ = poll("train_straggler at the head", lambda: head.call(
            "events_dump", {"type": "train_straggler"}, timeout=10), 30,
            period=0.3)
        ev = evs[-1]
        assert ev["host"] == "1" and ev["rank"] == 1, ev
        assert ev["world_size"] == 2 and ev["trace_id"].startswith(
            "train:"), ev
        assert ev["slowdown_factors"]["step"] > 2.0, ev
        assert len(evs) <= 2, [e["seq"] for e in evs]

        def skew():
            agg = head.call("metrics_dump", timeout=10) or {}
            vals = (agg.get("train_phase_skew_s") or {}).get("values", {})
            return vals if any(k.endswith("|1") for k in vals) else None

        vals, _ = poll("train_phase_skew_s for host 1", skew, 20,
                        period=0.3)
    finally:
        rt.shutdown()
        os.environ.pop(fi.ENV_VAR, None)
        fi.reset()
    host1 = max(v for k, v in vals.items() if k.endswith("|1"))
    host0 = max([v for k, v in vals.items() if k.endswith("|0")],
                default=0.0)
    assert host1 > STRAGGLER_SLEEP_S / 2 and host0 <= host1, vals
    flash = {n: result.metrics["launches"][n] for n in (
        "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")}
    steps = result.metrics["steps"]
    assert flash == dict.fromkeys(flash, steps if cuda else 0), \
        (flash, steps)
    assert result.metrics["launches"][
        "flash_attention_fwd_reference_cuda"] == 0
    log(f"22e: one train_straggler event (host {ev['host']}, rank "
        f"{ev['rank']}, slowdown {ev['slowdown_factors']}, trace "
        f"{ev['trace_id']}); skew host 1 {host1:.3f} s, host 0 "
        f"{host0:.3f} s; rank 0 {result.metrics['_step']} reports, flash "
        f"launches {flash}; phase 22e {time.monotonic() - t_phase:.1f} s; "
        f"{card}")
    return {"flash": flash}


def phase_runtime_faults(main_streams=None, model_config=None,
                         engine_config=None, card=""):
    """Phase 22: the runtime's failures with card workers: 22a and 22d
    (``phase_head_restart``), 22b (``phase_lineage_spill``), 22c
    (``phase_oom``, its cap from 22b's RSS) and 22e
    (``phase_straggler``, two cards). -> the ragged and flash launches,
    and 22a's first ``llm.ragged_step`` record."""
    t_phase = time.monotonic()
    free_card()
    a = phase_head_restart(model_config, engine_config,
                           main_streams=main_streams, card=card)
    free_card()
    b = phase_lineage_spill(card=card)
    free_card()
    c = phase_oom(b["rss"], card=card)
    free_card()
    e = phase_straggler(card=card)
    flash = dict.fromkeys(("flash_attention_fwd", "flash_attention_dq",
                           "flash_attention_dkv"), 0)
    flash["flash_attention_fwd"] = b["launches"] + c["launches"]
    for n, k in (e or {}).get("flash", {}).items():
        flash[n] += k
    log(f"phase 22: {time.monotonic() - t_phase:.1f} s, ragged launches "
        f"{a['launches']}, flash launches {flash}; {card}")
    return {"ragged": a["launches"], "flash": flash,
            "ragged_record": a["ragged_record"]}


# ----------- phase 23: the object plane carrying flash outputs, compiles

#: 23a: tests/test_object_transfer.py's chunk size and health checks, with
#: telemetry flushed each second (23b reads the card worker's counts)
TRANSFER_CONFIG = {"object_transfer_chunk_bytes": 256 * 1024,
                   "health_check_period_ms": 200,
                   "health_check_timeout_ms": 1500,
                   "metrics_export_period_s": 1.0}
TRANSFER_CPUS = 2
#: the integrity output's seed (its q, k, v drawn again on node C for the
#: step into the card); the spill step's outputs and the ones read back
TRANSFER_SEED = 23
SPILL_SEEDS = (0, 1, 2, 3, 4)
SPILL_READS = (0, 1, 4)
#: the broadcast's consumers, in order
BROADCAST_NODES = ("nodeA", "nodeC", "nodeA", "nodeC")
#: the arenas in outputs: B holds 2.5 (as 22b's), A the copies it reads, C
#: the inputs it makes and the copies it reads
TRANSFER_ARENAS = {"nodeA": 4.0, "nodeB": 2.5, "nodeC": 8.0}


def transfer_inputs(shape, dtype, seed, device="cpu"):
    """q, k, v [B, L, H, D] of ``shape`` (B, H, L, D) drawn from ``seed``
    by a generator on ``device``: on the CPU the same bits on every
    node."""
    B, H, L, D = shape
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, L, H, D, generator=g, dtype=dtype, device=device)
            for _ in range(3)]


def tensor_digest(t):
    """The sha256 of a tensor's bytes (on the CPU)."""
    import hashlib
    t = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(t.numpy()).hexdigest()


def output_digests(out):
    """The digests of a flash output {"o", "lse"}."""
    return {n: tensor_digest(out[n]) for n in ("o", "lse")}


class TransferNode:
    """23a's worker on node A or C: reads an output whose ref it is given
    in a list (so it pulls the object itself), and on C makes the inputs
    of the step into the card."""

    def started(self):
        return time.time()

    def read(self, refs):
        """-> the digests of ``refs[0]`` and the ``get``'s seconds."""
        import ray_tpu_torch as rt
        t0 = time.perf_counter()
        out = rt.get(refs[0], timeout=600)
        get_s = time.perf_counter() - t0
        return {"digests": output_digests(out), "get_s": get_s}

    def make_inputs(self, shape, dtype, seed):
        """``transfer_inputs`` on the CPU, as three objects."""
        return tuple(transfer_inputs(shape, dtype, seed))


class TransferCard:
    """23a's card worker (``num_gpus=1``, node B), kept across the
    sub-steps: the flash forward on q, k, v drawn from a seed or passed
    in; each execution's output digests, flash launches and seconds. Its
    start is split where it runs: the CUDA context, then the flash
    library's load."""

    def __init__(self, shape, dtype, device):
        import os
        import ray_tpu_torch as rt
        self.start = {"init_at": time.time(), "pid": os.getpid(),
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                      "worker": rt.get_runtime_context().worker_id.hex()}
        self.shape, self.dtype = shape, dtype
        self.device = torch.device(device)
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.zeros(1, device=self.device)
            torch.cuda.synchronize()
        self.start["cuda_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from ray_tpu_torch.ops import _kernels
            _kernels.load("flash_attention_fwd")
        self.start["library_s"] = time.perf_counter() - t0

    def started(self):
        return self.start

    def _flash(self, q, k, v, times):
        from ray_tpu_torch.ops import flash_attention as tfa
        before = dict(tfa.launch_counts)
        dev = self.device
        t0 = time.perf_counter()
        o, lse = tfa.flash_attention_block(q.to(dev), k.to(dev), v.to(dev),
                                           causal=True)
        out = {"o": o.cpu(), "lse": lse.cpu()}
        times["flash_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        digests = output_digests(out)
        times["digest_s"] = time.perf_counter() - t0
        launches = {n: tfa.launch_counts[n] - before[n] for n in before}
        return out, {"digests": digests, "launches": launches,
                     "times": times}

    def flash(self, seed, where="cpu"):
        """The inputs drawn on ``where`` ("cpu": the bits node C draws;
        else the card): -> the output (left in B's arena) and its
        digests."""
        t0 = time.perf_counter()
        qkv = transfer_inputs(self.shape, self.dtype, seed,
                              self.device if where != "cpu" else "cpu")
        return self._flash(*qkv, {"draw_s": time.perf_counter() - t0})

    def flash_on(self, q, k, v):
        """q, k, v passed in (pulled to B in chunks): -> the digests and
        launches."""
        return self._flash(q, k, v, {})[1]

    def put_outputs(self, seeds):
        """Each seed's output (inputs drawn on the card) put from this
        worker: -> the refs, and each one's digests and put seconds."""
        import ray_tpu_torch as rt
        refs, metas = [], []
        for seed in seeds:
            out, meta = self.flash(seed, where="card")
            t0 = time.perf_counter()
            refs.append(rt.put(out))
            meta["times"]["put_s"] = time.perf_counter() - t0
            metas.append(meta)
        return refs, metas


def gbps(nbytes, seconds):
    return nbytes / seconds / 1e9 if seconds > 0 else float("inf")


def phase_transfer(shape=FLASH_SHAPE, dtype=torch.bfloat16, device="cuda",
                   num_gpus=1, card=""):
    """23a: a ``Cluster`` of nodes A, B and C (B alone names the card), 256
    KiB chunks; one ``TransferCard`` on B and one ``TransferNode`` on A and
    on C across the sub-steps, started together.
    Integrity: its flash output on seed TRANSFER_SEED (o and lse, ~390
    chunks at FLASH_SHAPE) read by the driver (on A) and a task on A, each
    digest the producer's, within flash's limit of the plain version.
    Broadcast: consumers on BROADCAST_NODES pull it themselves, equal
    digests; each pull's seconds and GB/s, and the holders after it. Into
    the card: q, k, v made on C, passed to the card worker, pulled in
    chunks: its output equal to the bit to the integrity output. Spill: the
    card worker puts SPILL_SEEDS' outputs past B's arena of 2.5 outputs;
    the driver reads SPILL_READS back in chunks, from B's spill files where
    they spilled, each equal to its recorded digests. The flash launches
    equal the card executions. -> {"launches": the flash forward's,
    "start": the card worker's start, split, "counts": its compile counts
    at the head}."""
    import os
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.config import GlobalConfig, reset_to_defaults
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.runtime.object_plane import spill_file_path
    cuda = device == "cuda"
    t_phase = time.monotonic()
    B_, H, L, D = shape
    out_bytes = B_ * L * H * D * dtype.itemsize + B_ * H * L * 4
    period = TRANSFER_CONFIG["metrics_export_period_s"]
    # the daemons take this process's settings: a fresh table with the
    # phase's over it, as init() applies
    reset_to_defaults()
    GlobalConfig.apply(TRANSFER_CONFIG)
    cluster = Cluster()
    out = {}
    try:
        nodes = {}
        for name, outputs in TRANSFER_ARENAS.items():
            resources = {name: 1.0}
            if name == "nodeB" and num_gpus:
                resources["GPU"] = float(num_gpus)
            nodes[name] = cluster.add_node(
                num_cpus=TRANSFER_CPUS, resources=resources,
                object_store_bytes=int(outputs * out_bytes)).node_id
        rt.init(address=cluster.address, _system_config=TRANSFER_CONFIG)
        plane = global_worker.backend.object_plane
        assert plane.local_node_id == nodes["nodeA"], \
            "the driver is not on node A"
        shm = {n["node_id"]: n["shm_name"] for n in
               global_worker.backend.head.call("list_nodes", timeout=10)}
        names = {v: k for k, v in nodes.items()}

        def holders(ref):
            oid = ref.id()
            where = {plane.locations.get(oid, plane.local_node_id)}
            with plane._lock:
                where |= set(plane.secondary.get(oid, ()))
            return sorted(names.get(n, n[:8]) for n in where)

        # the card worker on B and a worker on A and on C, started
        # together: one start each for the whole phase
        t_submit = time.time()
        t0 = time.monotonic()
        worker = rt.remote(num_gpus=1, resources={"nodeB": 0.1})(
            TransferCard).remote(shape, dtype, device)
        node_cls = rt.remote(TransferNode)
        on = {n: node_cls.options(resources={n: 0.1}).remote()
              for n in ("nodeA", "nodeC")}
        start = rt.get(worker.started.remote(), timeout=600)
        start["ready_s"] = time.monotonic() - t0
        start["spawn_s"] = start["init_at"] - t_submit
        assert start["visible"] == "0", start
        rt.get([w.started.remote() for w in on.values()], timeout=600)
        ready_s = time.monotonic() - t0

        # integrity: the output read by the driver, then a task on A
        t0 = time.monotonic()
        ref, meta_ref = worker.flash.options(num_returns=2).remote(
            TRANSFER_SEED)
        produced = rt.get(meta_ref, timeout=600)
        flash_s = time.monotonic() - t0
        t0 = time.monotonic()
        first = rt.get(ref, timeout=600)
        driver_s = time.monotonic() - t0
        ratio = flash_against_plain(
            first, shape, dtype, device,
            transfer_inputs(shape, dtype, TRANSFER_SEED))
        got = output_digests(first)
        del first
        on_a = rt.get(on["nodeA"].read.remote([ref]), timeout=600)
        assert got == produced["digests"] == on_a["digests"], \
            (got, produced, on_a)
        chunks = -(-out_bytes // TRANSFER_CONFIG[
            "object_transfer_chunk_bytes"])
        times = produced["times"]
        log(f"23a integrity: the workers on B, A and C ready in "
            f"{ready_s:.2f} s; the flash output (o and lse, {out_bytes} "
            f"bytes, {chunks} chunks) made on node B in {flash_s:.2f} s "
            f"(q, k, v drawn on the host {times['draw_s']:.2f} s, the "
            f"flash forward with the copies {times['flash_s']:.3f} s, "
            f"digests {times['digest_s']:.3f} s), its sha256 o "
            f"{got['o'][:12]} lse {got['lse'][:12]} equal at the "
            f"producer, the driver on A (get {driver_s:.3f} s, "
            f"{gbps(out_bytes, driver_s):.2f} GB/s) and a task on A (get "
            f"{on_a['get_s']:.3f} s, the copy on A); within {ratio:.3f} of "
            f"flash's limit of the plain version")

        # broadcast: each consumer pulls the output itself
        pulls = []
        for node in BROADCAST_NODES:
            before = holders(ref)
            r = rt.get(on[node].read.remote([ref]), timeout=600)
            assert r["digests"] == got, (node, r)
            pulls.append((node, before, r["get_s"]))
        log("23a broadcast: " + "; ".join(
            f"{node} get {s:.3f} s ({gbps(out_bytes, s):.2f} GB/s), "
            f"holders before it {h}" for node, h, s in pulls)
            + f"; holders after {holders(ref)}; digests equal")

        # into the card: q, k, v made on C, pulled to B in chunks
        in_bytes = 3 * B_ * L * H * D * dtype.itemsize
        t0 = time.monotonic()
        made = on["nodeC"].make_inputs.options(num_returns=3).remote(
            shape, dtype, TRANSFER_SEED)
        rt.wait(list(made), num_returns=3, timeout=600)
        made_s = time.monotonic() - t0
        t0 = time.monotonic()
        into = rt.get(worker.flash_on.remote(*made), timeout=600)
        into_s = time.monotonic() - t0
        assert into["digests"] == got, (into, got)
        into_launches = into["launches"]
        log(f"23a into the card: q, k, v ({in_bytes} bytes of CPU tensors) "
            f"made on node C in {made_s:.2f} s, passed to the card worker "
            f"on B, pulled in chunks and moved to the card: the flash "
            f"output equal to the bit to the one on inputs drawn on B; the "
            f"call {into_s:.2f} s ({gbps(in_bytes, into_s):.2f} GB/s of "
            f"inputs)")
        del made, into

        # spill: five outputs put on B past its arena of 2.5
        t0 = time.monotonic()
        refs, metas = rt.get(worker.put_outputs.remote(SPILL_SEEDS),
                             timeout=600)
        put_s = time.monotonic() - t0

        def spill_path(r):
            return spill_file_path(GlobalConfig.session_dir,
                                   shm[nodes["nodeB"]], r.id().hex())

        spilled = [s for s, r in zip(SPILL_SEEDS, refs)
                   if os.path.exists(spill_path(r))]
        assert SPILL_SEEDS[-1] in spilled, spilled
        reads = []
        for i in SPILL_READS:
            from_file = os.path.exists(spill_path(refs[i]))
            t0 = time.monotonic()
            back = rt.get(refs[i], timeout=600)
            s = time.monotonic() - t0
            assert output_digests(back) == metas[i]["digests"], i
            reads.append((i, from_file, s))
            del back
        assert any(f for _, f, _ in reads), reads
        puts = ", ".join(f"{m['times']['put_s']:.3f}" for m in metas)
        log(f"23a spill: {len(SPILL_SEEDS)} outputs (inputs drawn on the "
            f"card) made and put on B in {put_s:.2f} s (the puts {puts} "
            f"s) past its arena of "
            f"{int(TRANSFER_ARENAS['nodeB'] * out_bytes)} bytes, seeds "
            f"{spilled} in B's spill files; the driver read " + ", ".join(
                f"{i} ({'spill file' if f else 'arena'}, {s:.3f} s, "
                f"{gbps(out_bytes, s):.2f} GB/s)" for i, f, s in reads)
            + ", each equal to its digests")

        launches = [produced["launches"], into_launches,
                    *[m["launches"] for m in metas]]
        out["launches"] = sum(x["flash_attention_fwd"] for x in launches)
        assert out["launches"] == (len(launches) if cuda else 0), launches
        assert all(x["flash_attention_fwd_reference_cuda"] == 0
                   for x in launches), launches
        out["start"] = start
        # 23b's reading: the card worker's compile counts at the head (its
        # library load, counted with no call in flight)
        wid = start["worker"]

        def counts():
            dump = global_worker.backend.head.call(
                "compiles_dump", {"worker": wid[:12]}, timeout=10)
            return next((c for k, c in dump["counts"].items()
                         if k.startswith(wid) and c.get("load")), None)

        out["counts"] = poll("the card worker's load at the head", counts,
                             10 * period, period=0.2)[0] if cuda else {}
        del ref, refs
        for w in (worker, *on.values()):
            rt.kill(w)
    finally:
        rt.shutdown()
        cluster.shutdown()
        reset_to_defaults()
    log(f"23a: {len(launches)} card executions, {out['launches']} flash "
        f"launches; the card worker's start {start['ready_s']:.2f} s "
        f"(spawn, imports and the class {start['spawn_s']:.2f} s, the CUDA "
        f"context {start['cuda_s']:.2f} s, the flash library's load "
        f"{start['library_s']:.3f} s); phase 23a "
        f"{time.monotonic() - t_phase:.1f} s; {card}")
    return out


def build_phases(tracker, built):
    """23b, on the driver's tracker started before the script's first
    ``build``: -> its export of the build (None when nothing was built).
    A cold build directory gives one ``cache_miss`` and one nameless
    ``backend_compile`` record per library built; a warm one, nothing."""
    export = tracker.export()
    records = (export or {}).get("records", [])
    counts = (export or {}).get("counts", {})
    assert counts.get("cache_miss", 0) == len(built), (counts, built)
    assert len(records) == len(built) == counts.get("backend_compile", 0), \
        (records, built)
    assert all(r["name"] == "" and r["kind"] == "backend_compile"
               and r["backend"] == "cuda" and r["backend_s"] > 0
               for r in records), records
    return export


def phase_compile_phases(build_export, ragged_record, transfer, card=""):
    """23b: the compile phases the port's own compiles reported. The
    build's records (``build_phases``); the first ``llm.ragged_step``
    record of 22a's 8B server worker at the head, whose ``phases["load"]``
    is the ragged library's load; 23a's card worker's ``load`` count at
    the head. Prints the libraries' load seconds beside the card workers'
    start seconds."""
    records = (build_export or {}).get("records", [])
    if records:
        line = (f"23b: a cold build directory: {len(records)} nameless "
                f"backend_compile records, each library's nvcc seconds "
                + ", ".join(f"{r['backend_s']:.2f}" for r in records)
                + f", cache_miss {build_export['counts']['cache_miss']}")
    else:
        line = "23b: a warm build directory: no record, no cache miss"
    phases = ragged_record["phases"]
    assert "load" in phases, ragged_record
    assert transfer["counts"].get("load") == 1, transfer["counts"]
    start = transfer["start"]
    log(f"{line}; 22a's 8B worker, its first llm.ragged_step record (nth "
        f"{ragged_record['nth']}, {ragged_record['duration_s']:.3f} s): "
        f"phases {phases}, the ragged library's load "
        f"{phases['load']:.4f} s; 23a's card worker: load count "
        f"{transfer['counts']['load']} at the head, its start "
        f"{start['ready_s']:.2f} s = spawn, imports and the class "
        f"{start['spawn_s']:.2f} s + the CUDA context {start['cuda_s']:.2f} "
        f"s + the flash library's load {start['library_s']:.4f} s; {card}")


def main():
    t_script = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (REPO / "ray_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: no ray_tpu_torch sources beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)

    from ray_tpu_torch.ops import _kernels
    from ray_tpu_torch.util import compile_tracker
    # 23b: the driver's tracker hears the build's compiles
    tracker = compile_tracker.ensure_started(role="driver")
    assert tracker is not None, "the compile tracker is off"
    t0 = time.monotonic()
    built = _kernels.build()
    build_export = build_phases(tracker, built)
    log(f"kernels built in {time.monotonic() - t0:.1f} s: "
        f"{sorted(built) or 'all up to date'}")
    for lib, kernel in SM90_KERNELS:
        build_log = built.get(lib) or _kernels.build_log(lib)
        if kernel.startswith("flash_"):   # each tile variant on its own
            for args, report in ptxas_instantiations(build_log, kernel):
                log(f"ptxas, {kernel}<{args}>: {report}")
        else:
            log(f"ptxas, {kernel}: {ptxas_report(build_log, kernel)}")
    smem = flash_variant_smem()
    log("flash tile variants' shared memory (bytes, the libraries' count "
        "= the tuner's model): " + ", ".join(
            f"{str(dt).removeprefix('torch.')} D{D} {kern} {tile} {n}"
            for (dt, D, kern, tile), n in smem.items()))

    kern = phase_kernel(device)
    decode = phase_decode(device)
    free_card()
    # the main path is the first engine of the process, so the step
    # programs it dispatched are all the process holds
    main_base = memory_baseline()
    stats, launches, expected, programs, main_streams = phase_main_path()
    main_peak = (main_base, torch.cuda.max_memory_allocated())
    assert launches["ragged_paged_attention"] == expected, \
        (launches, expected)
    assert launches["ragged_paged_attention_reference_cuda"] == 0, \
        "the plain attention ran on CUDA tensors in the main path"
    assert programs[0] == 0 and programs[1] <= 3, programs
    # 18d: the compile tracker's records of phase 4, then its cost, while
    # phase 4's engine is still the only one the process ran
    free_card()
    tracker_launches = phase_tracker(programs[1])
    free_card()
    decode_launches = phase_decode_engine()
    phase_oracle(device)
    # bench_llm.py's widths: the kernels at head dim 64 and pages of 32,
    # then a server at those widths, its launches counted, and the fp32
    # engine against the full forward there
    kern_bench = phase_kernel(device, BENCH_GEOMETRY)
    _, bench_launches, bench_expected, _, _ = phase_main_path(
        BENCH_MODEL, BENCH_ENGINE, launch_stamp_fails=False)
    assert bench_launches["ragged_paged_attention"] == bench_expected, \
        (bench_launches, bench_expected)
    assert bench_launches["ragged_paged_attention_reference_cuda"] == 0, \
        "the plain attention ran on CUDA tensors at the bench widths"
    from ray_tpu_torch.llm.serve_llm import model_config_from_dict
    phase_oracle(device, dataclasses.replace(
        model_config_from_dict(BENCH_MODEL), dtype=torch.float32),
        page_size=BENCH_ENGINE["page_size"])
    phase_recorder_ab()
    phase_batch_predictor()

    flash = phase_flash(device)
    phase_flash_lengths(device)
    flash_launches, steps, n_layers = phase_train(device)
    assert flash_launches == expected_flash_launches(n_layers, steps), \
        flash_launches
    free_card()
    # the earlier optimizer on the same configuration, for comparison
    adamw_launches, adamw_steps, _ = phase_train(
        device, optimizer="adamw", steps=3, profile=False)
    assert adamw_launches == expected_flash_launches(n_layers, adamw_steps), \
        adamw_launches
    free_card()
    # 7b: the sweep, eagerly, then phase 7's step with the picked tiles,
    # and with every kernel's second variant; the cache is emptied after,
    # so every later phase launches what it launched before
    from ray_tpu_torch.ops import flash_attention as tfa
    tuned_runs = [phase_train_tiles(device, phase_autotune(device), "tuned")]
    free_card()
    tuned_runs.append(phase_train_tiles(
        device, tfa.tile_variants(torch.bfloat16, FLASH_SHAPE[3])[1],
        "second variants"))
    tfa.clear_block_cache()
    free_card()
    phase_train_oracle(device)
    phase_optimizer(device)
    free_card()
    mixtral_params, mixtral_cfg = phase_mixtral(device, card=card)
    phase_mixtral_routing(device, mixtral_params, mixtral_cfg)
    del mixtral_params
    free_card()
    phase_mixtral_oracle(device)
    free_card()
    phase_rl(device, card)
    free_card()

    t_data = time.monotonic()
    data_launches, data_expected = phase_batch_inference()
    assert data_launches["ragged_paged_attention"] == data_expected, \
        (data_launches, data_expected)
    assert data_launches["ragged_paged_attention_reference_cuda"] == 0, \
        "the plain attention ran on CUDA tensors in batch_inference"
    free_card()
    rows_launches, rows_expected = phase_batch_rows()
    assert rows_launches["ragged_paged_attention"] == rows_expected, \
        (rows_launches, rows_expected)
    assert rows_launches["ragged_paged_attention_reference_cuda"] == 0
    free_card()
    phase_bc(device, card=card)
    log(f"phase 12: {time.monotonic() - t_data:.1f} s")
    free_card()
    t_tune = time.monotonic()
    phase_tune(device)
    log(f"phase 13: {time.monotonic() - t_tune:.1f} s")
    # the cluster runtime: phase 4's server in a GPU-leased worker process
    free_card()
    phase_cluster(main_streams=main_streams, card=card)
    # Serve: phase 4's server as a deployment in a replica holding the card
    phase_serve(main_streams=main_streams, card=card)
    # the mesh and distributed training: the flash kernels per shard, then
    # TorchTrainer with the card in a leased worker
    t_mesh = time.monotonic()
    free_card()
    phase_flash_shards(device, flash)
    trainer_launches = phase_trainer(device, card=card)
    log(f"phase 16: {time.monotonic() - t_mesh:.1f} s")
    # the parallel axes left: tensor-parallel serving with the ragged
    # kernel per shard, the ragged kernel at the shards' geometry, and the
    # ring's flash blocks
    t_axes = time.monotonic()
    tp_serving = phase_tp_serving(
        main_streams=main_streams,
        main_launches=launches["ragged_paged_attention"],
        main_peak=main_peak, card=card)
    free_card()
    kern_shards = []
    for tp, geometry in TP_SHARD_GEOMETRY.items():
        log(f"the ragged kernel at a tp {tp} shard's geometry:")
        kern_shards += phase_kernel(device, geometry).values()
    tp4 = phase_tp_shards(device)
    free_card()
    ring_block_against_plain(device)
    ring = phase_ring_blocks(device, card=card)
    log(f"phase 17: {time.monotonic() - t_axes:.1f} s")
    # the DAGs and the RL learners on a mesh (18d ran after phase 4)
    t_dags = time.monotonic()
    free_card()
    dag = phase_compiled_dag(device)
    free_card()
    phase_actor_dag()
    phase_rl_mesh(device)
    log(f"phase 18a-c: {time.monotonic() - t_dags:.1f} s")
    # the operations surface: phase 4's server in a job's placement group
    # on a multi-node Cluster, the CLI and dashboard against it, then the
    # autoscaler launching a GPU node for a pending bundle
    free_card()
    ops = phase_operations(main_streams=main_streams, card=card)
    # several cards: each sub-phase logs its skip below the cards it needs
    multi = phase_multicard(main_streams=main_streams,
                            main_launches=launches["ragged_paged_attention"],
                            main_peak=main_peak, card=card)
    # the engine under memory pressure: int8 pools at phase 4's traffic,
    # copy-on-write, eviction and recompute preemption, tp=2 over int8
    free_card()
    pressure = phase_pressure(main_streams,
                              launches["ragged_paged_attention"], card=card)
    # the runtime's failures with card workers: a head restart under the 8B
    # server, lineage and spill of a flash output, an OOM kill, the
    # observability planes on a card worker, a straggler over two cards
    faults = phase_runtime_faults(main_streams, card=card)
    # the object plane carrying flash outputs between three nodes, and the
    # compile phases of the port's own compiles
    t_transfer = time.monotonic()
    free_card()
    transfer = phase_transfer(card=card)
    phase_compile_phases(build_export, faults["ragged_record"], transfer,
                         card=card)
    log(f"phase 23: {time.monotonic() - t_transfer:.1f} s; {card}")
    log(f"the whole script {time.monotonic() - t_script:.1f} s")

    bf16 = kern["bf16"]
    record = {"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/ragged_paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:340",
        "launches": launches["ragged_paged_attention"]
        + tp_serving["launches"] + tp4["launches"] + tracker_launches
        + ops["launches"] + multi["ragged"] + pressure["launches"]
        + faults["ragged"],
        "max_abs_err": max([k["max_abs_err"] for k in [
            *kern.values(), *kern_bench.values(), *kern_shards]]
            + [pressure["max_abs_err"]]),
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"]}, {
        "name": "paged_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:92",
        "launches": decode_launches,
        "max_abs_err": max(d["max_abs_err"] for d in decode.values()),
        **{k: decode["A bfloat16"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}] + [{
        "name": name, "route": "cuda",
        "source": f"ray_tpu_torch/ops/csrc/{src}",
        "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
        "launches": flash_launches[name] + trainer_launches[name]
        + sum(r[name] for r in tuned_runs)
        + sum(r["launches"][name] for r in ring.values())
        + (dag["launches"] if name == "flash_attention_fwd" else 0)
        + sum(m[name] for m in multi["flash"]) + faults["flash"][name]
        + (transfer["launches"] if name == "flash_attention_fwd" else 0),
        **flash[name]}
        for name, src, line in (
            ("flash_attention_fwd", "flash_attention_fwd.cu", 91),
            ("flash_attention_dq", "flash_attention_bwd.cu", 139),
            ("flash_attention_dkv", "flash_attention_bwd.cu", 175))]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
