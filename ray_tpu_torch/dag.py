"""Lazy task DAGs: fn.bind(...) -> DAGNode -> execute().

The port of ``ray_tpu/dag.py`` (reference: dag/dag_node.py:32 DAGNode,
function_node.py / input_node.py): binding builds the graph without
executing; execute() walks it bottom-up, submits each node ONCE as a task
(diamond dependencies deduplicate), and wires parent results in as
ObjectRefs so the data plane moves values directly between workers.

``experimental_compile`` compiles a bound graph for repeated execution:

- a graph of pure stage functions becomes a ``CompiledDAG``. Where the
  JAX package jits the whole graph into one XLA program, here the stages
  run once in topological order and, for CUDA tensors, are captured in
  one ``torch.cuda.CUDAGraph`` per input signature; each execute replays
  it. The graph removes the host's per-stage orchestration (Python, the
  dispatcher, one launch call per kernel) and the intermediates stay on
  the card, but it does not fuse stages into one kernel the way XLA does:
  every kernel of every stage still runs, one after the other;
- a linear chain of actor methods becomes a ``CompiledActorDAG``:
  pre-launched loops on the actors wired by shm channel rings
  (``runtime/channel.py``), the multi-process pipeline the reference
  calls aDAG.

This module imports neither torch nor jax at import time: torch is
imported where a ``CompiledDAG`` executes.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class DAGNode:
    """One bound task invocation in a lazy graph."""

    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        self._fn = remote_fn
        self._args = args
        self._kwargs = kwargs

    def execute(self, _cache: Optional[Dict[int, Any]] = None):
        """Submit the whole graph; returns this node's ObjectRef."""
        cache: Dict[int, Any] = _cache if _cache is not None else {}
        return self._submit(cache)

    def _resolved(self, cache: Dict[int, Any]):
        def resolve(v):
            if isinstance(v, DAGNode):
                return v._submit(cache)
            if isinstance(v, InputNode):
                return v._value()
            return v

        return (tuple(resolve(a) for a in self._args),
                {k: resolve(v) for k, v in self._kwargs.items()})

    def _submit(self, cache: Dict[int, Any]):
        if id(self) in cache:
            return cache[id(self)]
        args, kwargs = self._resolved(cache)
        ref = self._fn.remote(*args, **kwargs)
        cache[id(self)] = ref
        return ref

    @property
    def name(self) -> str:
        return getattr(self._fn, "__name__", None) or getattr(
            getattr(self._fn, "underlying_function", None), "__name__",
            "fn")

    def __repr__(self):
        return f"DAGNode({self.name})"


class InputNode:
    """Placeholder for execute-time input (reference: dag/input_node.py).

    Usage:
        with InputNode() as inp:
            dag = f.bind(inp)
        ray_tpu_torch.dag.execute_with_input(dag, 5)
    """

    def __init__(self):
        self._bound_value: Any = _UNSET

    def __enter__(self) -> "InputNode":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def _value(self):
        if self._bound_value is _UNSET:
            raise ValueError("InputNode used but no input supplied — "
                             "call execute_with_input(value)")
        return self._bound_value


_UNSET = object()


def execute_with_input(dag: DAGNode, value: Any):
    """Execute a DAG that contains InputNode placeholders."""
    inputs = _find_inputs(dag)
    for node in inputs:
        node._bound_value = value
    try:
        return dag.execute()
    finally:
        for node in inputs:
            node._bound_value = _UNSET


#: the modules whose kernel launch counters a CUDA graph's replay adds to
_COUNTED_OPS = ("ray_tpu_torch.ops.flash_attention",
                "ray_tpu_torch.ops.paged_attention")


def _counted_ops():
    import importlib
    return [importlib.import_module(m) for m in _COUNTED_OPS]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class _Captured:
    """One input signature's CUDA graph: the static input it reads, the
    static output it writes, and the kernel launches its capture counted
    (per counted ops module), which each replay adds again."""

    def __init__(self, graph, static_in, static_out, launches):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches


class CompiledDAG:
    """One program standing in for the whole bound graph of pure stage
    functions (reference: CompiledDAG — execute() without per-node task
    overhead; the JAX package's ``jax.jit(run)``).

    ``execute(x)`` runs on the input's device:

    - a CUDA tensor: at the first call for its signature (shape, dtype,
      device) the stages run once as a warm-up on a side stream, then are
      captured in a ``torch.cuda.CUDAGraph``; every call copies ``x``
      into the captured input, replays the graph and returns a clone of
      the output (a result kept from one call is never overwritten by the
      next, as a jitted function returns fresh arrays). A new signature
      captures a new graph, as ``jit`` re-traces. A stage that cannot be
      captured (a host sync such as ``.item()``, a CPU tensor read back)
      raises with its name; the graph never quietly runs eagerly;
    - a CPU tensor: the stages run eagerly in the same order;
    - a numpy array or a Python scalar goes to the port's default
      device, the card, first (``resolve_device`` raises without one).

    Each new capture (on the CPU, each new signature) is a compile that
    the process's compile tracker records (``util/compile_tracker.py``,
    ``dag.compiled``); a capture's seconds, its instantiation included,
    are the record's ``backend_compile`` phase. On the CPU nothing is
    captured and the record has no phase, where JAX's jit reports its
    compile. The kernels' launch counters (``ops/``) count on
    the host, where a replay launches nothing: the launches counted while
    capturing are taken back (the capture runs nothing), and each replay
    adds them once, so the counters stay true under the graph.
    """

    def __init__(self, dag: DAGNode):
        order, inputs = _topo(dag)
        if not inputs:
            raise ValueError("experimental_compile needs an InputNode "
                             "driving the graph")
        self._order = order
        self._inputs = inputs
        self._programs: Dict[tuple, Optional[_Captured]] = {}
        from ray_tpu_torch.util import compile_tracker
        tracker = compile_tracker.ensure_started()
        self._call = self._execute if tracker is None else tracker.wrap(
            self._execute, name="dag.compiled",
            probe=lambda: len(self._programs))

    def _run(self, x, on_stage=None):
        values: Dict[int, Any] = {id(n): x for n in self._inputs}

        def resolve(v):
            if isinstance(v, (DAGNode, InputNode)):
                return values[id(v)]
            return v
        out = None
        for node in self._order:
            if on_stage is not None:
                on_stage(node)
            args = tuple(resolve(a) for a in node._args)
            kwargs = {k: resolve(v) for k, v in node._kwargs.items()}
            out = node._fn.underlying_function(*args, **kwargs)
            values[id(node)] = out
        return out

    def execute(self, x):
        """Run the compiled graph; returns the final node's value (a
        tensor or a tree of them, not an ObjectRef — there is no task)."""
        import torch
        if not isinstance(x, torch.Tensor):
            from ray_tpu_torch.models.llama import resolve_device
            x = torch.as_tensor(x, device=resolve_device("cuda"))
        return self._call(x)

    def _execute(self, x):
        sig = (tuple(x.shape), x.dtype, x.device)
        if x.device.type != "cuda":
            self._programs.setdefault(sig, None)
            return self._run(x)
        captured = self._programs.get(sig)
        if captured is None:
            captured = self._programs[sig] = self._capture(x)
        captured.static_in.copy_(x)
        captured.graph.replay()
        for module, delta in captured.launches:
            module.add_launches(delta)
        return _tree_map(lambda t: t.clone() if hasattr(t, "clone") else t,
                         captured.static_out)

    def _capture(self, x) -> _Captured:
        import torch
        static_in = x.clone()
        stage: List[Any] = [None]

        def note(node):
            stage[0] = node

        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            self._run(static_in, note)     # warm-up: real, counted launches
        torch.cuda.current_stream(x.device).wait_stream(side)
        modules = _counted_ops()
        before = [dict(m.launch_counts) for m in modules]
        graph = torch.cuda.CUDAGraph()
        stage[0] = None
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):     # capture, then instantiate
                static_out = self._run(static_in, note)
        except Exception as e:  # noqa: BLE001 — named and re-raised
            name = stage[0].name if stage[0] is not None else "?"
            raise RuntimeError(
                f"CompiledDAG: stage {name!r} cannot be captured in a CUDA "
                f"graph ({type(e).__name__}: {e}); a captured stage must "
                f"not sync with the host (.item(), .cpu(), a CPU tensor "
                f"read back)") from e
        from ray_tpu_torch.util import compile_tracker
        compile_tracker.note_phase("backend_compile",
                                   time.perf_counter() - t0, backend="cuda")
        launches = []
        for m, b in zip(modules, before):
            delta = {k: v - b[k] for k, v in m.launch_counts.items()
                     if v != b[k]}
            if delta:
                # the capture launched nothing: take its counts back
                m.add_launches({k: -v for k, v in delta.items()})
                launches.append((m, delta))
        return _Captured(graph, static_in, static_out, launches)

    def captures(self) -> int:
        """CUDA graphs captured so far (one per CUDA input signature)."""
        return sum(c is not None for c in self._programs.values())


class ActorMethodNode(DAGNode):
    """A bound ACTOR method call in a lazy graph (reference:
    dag/class_node.py ClassMethodNode). Created via
    ``actor_handle.method.bind(...)``."""

    def __init__(self, handle, method_name: str, args: tuple, kwargs: dict):
        self._handle = handle
        self._method_name = method_name
        self._args = args
        self._kwargs = kwargs

    def _submit(self, cache: Dict[int, Any]):
        if id(self) in cache:
            return cache[id(self)]
        args, kwargs = self._resolved(cache)
        ref = getattr(self._handle, self._method_name).remote(*args, **kwargs)
        cache[id(self)] = ref
        return ref

    @property
    def name(self) -> str:
        return self._method_name

    def __repr__(self):
        return f"ActorMethodNode({self._method_name})"


class DagRef:
    """Result handle for one CompiledActorDAG execution. Results arrive
    on the output channel in submission order; get() drains the channel
    up to this execution's slot."""

    def __init__(self, owner: "CompiledActorDAG", seq: int):
        self._owner = owner
        self._seq = seq

    def get(self, timeout: Optional[float] = 60.0):
        return self._owner._result(self._seq, timeout)


class CompiledActorDAG:
    """Pre-launched per-actor execution loops wired by shm channel rings
    (reference: dag/compiled_dag_node.py:767 — do_exec_tasks at :188 +
    experimental/channel/): compile() starts a long-lived loop on every
    participating actor that reads its input ring, runs the bound method,
    and writes its output ring. execute(x) writes the input ring and
    returns a DagRef — no per-call task submission, scheduling, or RPC;
    ring capacity gives pipelining across executions.

    Constraints (v1, mirrors the reference's aDAG restrictions): the
    graph must be a linear chain InputNode -> a.m -> b.m -> ...; all
    actors must live on the driver's node (channels ride the node's shm
    arena — the cross-node extension is a channel proxied over the
    object plane); while compiled, eager calls to the same actors race
    the loop thread against the task queue.
    """

    def __init__(self, dag: ActorMethodNode, capacity: int = 8,
                 start_timeout: float = 60.0):
        import os
        import time

        from ray_tpu_torch.core.worker import require_connected
        from ray_tpu_torch.runtime.channel import ShmChannel
        from ray_tpu_torch.runtime.protocol import RpcError

        chain = _linear_actor_chain(dag)
        worker = require_connected()
        backend = worker.backend
        store = getattr(getattr(backend, "object_plane", None), "store",
                        None)
        if store is None:
            raise ValueError("compiled actor DAGs need the cluster runtime "
                             "(channels ride the node's shm store); "
                             "local mode has none")
        base = os.urandom(6).hex()
        names = [f"{base}-{i}" for i in range(len(chain) + 1)]
        self._backend = backend
        self._names = names
        self._store = store
        self._capacity = capacity
        self._in = ShmChannel(store, names[0], capacity)
        self._out = ShmChannel(store, names[-1], capacity)
        self._next_seq = 0
        self._done_seq = -1
        self._results: Dict[int, Any] = {}
        self._torn_down = False
        for i, (handle, method) in enumerate(chain):
            deadline = time.monotonic() + start_timeout
            addr = None
            while time.monotonic() < deadline:
                info = backend.head.call_retrying(
                    "get_actor", {"actor_id": handle._actor_id.binary()})
                if info is None:
                    raise ValueError(f"actor {handle!r} is not registered")
                if info["state"] == "ALIVE":
                    addr = info["address"]
                    break
                if info["state"] == "DEAD":
                    raise ValueError(f"actor {handle!r} is dead: "
                                     f"{info.get('reason')}")
                time.sleep(0.05)
            if addr is None:
                raise TimeoutError(f"actor {handle!r} never became ALIVE")
            try:
                actor_node = backend.peers.get(addr).call(
                    "dag_start_loop", {
                        "in": names[i], "out": names[i + 1],
                        "method": method, "capacity": capacity}, timeout=30)
            except RpcError as e:
                raise RuntimeError(
                    f"failed to start dag loop on {handle!r}: {e}") from e
            # channels ride the node's shm arena: a cross-node actor would
            # attach a DIFFERENT store and the pipeline would hang — fail
            # loudly at compile time instead
            if actor_node != backend.local_node_id:
                self.teardown()
                raise ValueError(
                    f"compiled actor DAGs require every actor on the "
                    f"driver's node: {handle!r} is on node "
                    f"{str(actor_node)[:12]}, driver on "
                    f"{str(backend.local_node_id)[:12]}")

    def execute(self, x) -> DagRef:
        if self._torn_down:
            raise RuntimeError("compiled dag was torn down")
        # Sliding window: when every ring is full, the single-threaded
        # driver must CONSUME a finished result to free a slot — blocking
        # in put would deadlock the pipeline against itself.
        while not self._in.try_put(("v", x)):
            if self._done_seq + 1 < self._next_seq:
                self._results[self._done_seq + 1] = self._out.get(60.0)
                self._done_seq += 1
            else:  # nothing in flight: the ring is jammed, not full
                self._in.put(("v", x), timeout=60.0)
                break
        ref = DagRef(self, self._next_seq)
        self._next_seq += 1
        return ref

    def _result(self, seq: int, timeout: Optional[float]):
        if seq in self._results:
            tag, val = self._results.pop(seq)
        elif self._done_seq >= seq:
            raise ValueError(f"DagRef #{seq} was already consumed")
        else:
            while self._done_seq < seq:
                tag_val = self._out.get(timeout)
                self._done_seq += 1
                if self._done_seq == seq:
                    tag, val = tag_val
                    break
                self._results[self._done_seq] = tag_val
        if tag == "e":
            raise val
        return val

    def teardown(self) -> None:
        """Stop the actor loops (sentinel cascades down the chain) and
        free the channel slots."""
        if self._torn_down:
            return
        self._torn_down = True
        from ray_tpu_torch.runtime.channel import ChannelClosed, ShmChannel
        # the input ring may be full of unconsumed work: unjam by draining
        # outputs until the sentinel fits, or the loop threads never stop
        for _ in range(64):
            if self._in.close(timeout=1.0):
                break
            try:
                self._out.get(timeout=5.0)
            except (ChannelClosed, TimeoutError):
                break
        try:
            # drain until the sentinel falls out of the last channel
            while True:
                self._out.get(timeout=10.0)
        except (ChannelClosed, TimeoutError):
            pass
        for name in self._names:
            ShmChannel(self._store, name, self._capacity).drain()


def experimental_compile(dag: DAGNode, **opts):
    """Compile a bound graph for repeated execution.

    - Pure-function DAGs become a ``CompiledDAG``: one CUDA graph per
      input signature on the card, the stages in order on the CPU.
    - Actor-method chains compile into pre-launched per-actor loops fed
      by shm channel rings (``CompiledActorDAG``) — the multi-process
      pipeline the reference calls aDAG.
    """
    if isinstance(dag, ActorMethodNode):
        return CompiledActorDAG(dag, **opts)
    return CompiledDAG(dag)


def _linear_actor_chain(root: ActorMethodNode):
    """Validate + extract the chain [(handle, method), ...] root-last."""
    chain = []
    node: Any = root
    while isinstance(node, ActorMethodNode):
        deps = [a for a in list(node._args) + list(node._kwargs.values())
                if isinstance(a, (DAGNode, InputNode))]
        if len(deps) != 1:
            raise ValueError(
                "CompiledActorDAG v1 supports linear chains: each actor "
                f"node needs exactly one upstream, got {len(deps)}")
        chain.append((node._handle, node._method_name))
        node = deps[0]
    if not isinstance(node, InputNode):
        raise ValueError("the chain must start at an InputNode")
    chain.reverse()
    return chain


def _topo(root: DAGNode):
    """(topological node order, input nodes) for the graph under root."""
    order: List[DAGNode] = []
    inputs: List[InputNode] = []
    seen: set = set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, InputNode):
            inputs.append(n)
            return
        if isinstance(n, DAGNode):
            for v in list(n._args) + list(n._kwargs.values()):
                walk(v)
            order.append(n)   # parents first (post-order)
    walk(root)
    return order, inputs


def _find_inputs(node: DAGNode) -> List[InputNode]:
    return _topo(node)[1]
