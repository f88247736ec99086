"""Multi-pod dry run (port of ``repro/launch/dryrun.py``).

For every (architecture x input shape) pair this traces the port's real
train, prefill and decode steps on the production meshes, (16, 16) over
``("data", "model")`` and (2, 16, 16) over ``("pod", "data", "model")``,
over fake tensors (no allocation, no kernel), as rank 0 of a fake process
group, and counts what rank 0 would do:

* the bytes it holds (proves a plan fits),
* its FLOPs and the bytes its operations move,
* the bytes its collectives move,

and derives the three roofline terms from the NVIDIA H100 SXM5's datasheet
constants (:mod:`.mesh`: ``PEAK_FLOPS_BF16``, ``HBM_BW``, ``LINK_BW``).
The numbers are predictions, not measurements. Results land in
``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<gradsync>].json``.

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --mesh both --device cpu

How each part of the reference is carried over:

* ``XLA_FLAGS=--xla_force_host_platform_device_count=512`` at import: a
  ``"fake"`` process group of the mesh's world (256 or 512) at rank 0,
  started by :func:`run_one` (never at import) and destroyed after it, so
  the process is left as found. :func:`run_one` refuses to run while
  another process group is up: a process has one default group.
* ``jax.ShapeDtypeStruct`` with a ``NamedSharding``: ``FakeTensorMode``
  tensors of each rank's local shape, wrapped as DTensors with the
  placements of the port's sharding rules (:func:`param_placements` of
  ``param_specs``, ``batch_spec``, ``cache_specs``).
* ``jax.shard_map`` around the expert-parallel MoE forms:
  ``parallel.regions.shard_map``, which hands each rank's local tensors to
  the form's body at the reference's in specs and wraps its outputs at the
  out specs; inside, the routing, dispatch and the collectives over the
  model group run on local tensors (the collectives counted as the Canary
  trees' are).
* GSPMD propagation over the traced step: DTensor's sharding propagation
  over the port's own ``make_train_step``, ``forward`` and serve step
  (``serving.make_serve_step``: ``decode_step`` and the next token's
  ``argmax``, as the reference's decode rows run ``make_serve_step``).
  Under ``auto`` the step is built with no mesh, as the reference's
  ``auto`` has no explicit sync: DTensor's autograd inserts the gradient
  reductions GSPMD would. Under the explicit modes (``--grad-sync
  canary_fp``) the parameters are replicated over the data axes and
  sharded over the model axis, the step runs per data rank on the model
  axis (the reference's data-manual ``shard_map``), and the gradients'
  local tensors ride ``canary_allreduce_tree`` over the fake data groups:
  its trees and its ``all_reduce(MAX)`` are what the collective count sees.
  Where DTensor's rules fail or replicate what GSPMD splits, the dry run
  lays the operation out itself, on DTensor's own redistributions and each
  rank's local tensors, and says so here:

  - ``view`` and ``_unsafe_view``: the model code calls ``reshape`` (and
    ``einsum`` flattens its operands), DTensor sees the views they
    decompose into, whose rule refuses to split a sharded dim unevenly
    (the heads of q into (KV, G) groups; a decode step's grouped-query
    logits, where torch 2.11 refuses the flattening); ``reshape``'s rule,
    which reshards, is taken instead (:func:`_views_reshard`); a view
    that merges a dim a mesh dim splits behind a whole dim (the dense MoE
    route's (E, C, d) -> (E C, d) with C split) gathers that dim first,
    as torch 2.11 does, where 2.13's ``reshape`` rule gathers the rows and
    reorders them (:func:`_flatten_gathered`);
  - a product (``mm``, ``bmm``) of an activation and a weight: the weight
    is gathered over the data axes that split the tokens (FSDP), and the
    activation is made whole over the model axis where it splits the
    weight's output columns (Megatron) (:func:`_gather_weight`), where DTensor's
    cost model, greedy an operation at a time and blind to the size of the
    output, may gather the tokens or leave an output of every column; a
    weight dim split with the data axes over the model axis too (``wq``
    and ``wo`` where the heads do not divide it) is gathered over the
    model axis as well, as GSPMD does, and where such a dim is the
    contraction met by features the model axis splits (an
    encoder-decoder's cross-attention query), the partial sum is reduced
    whole at once; inside the model's ``parallel.layouts.keep_d_split``
    hook (an encoder-decoder's layers, where GSPMD keeps d split over the
    model axis because the cross-attention's query contracts it split),
    ``wo``'s output columns keep the model axis's share of d, and a step
    whose tokens hold fewer bytes than the weight's share (a decode) moves
    the tokens over the data axes and keeps the weight's split; neither
    rule holds for a decoder-only model (with the size test alone, five
    decodes' link bytes fall to 0.43-0.49 of the reference's); in the
    forward, a contraction that a data axis splits on both operands (a
    one-sequence decode, whose activations hold d as the embedding's
    split leaves it, over the idle data axes) is reduced at once, as
    GSPMD reduces the projections' partial sums; in the
    backward, a row-parallel
    product's partial sum (the gradient of a column-parallel input) is
    reduced whole, Megatron's all-reduce; a stacked weight's gradient
    against a partial sum over the data axes reduces the partial sum and
    keeps the buffer's split (DTensor gathers the buffer over a flattened
    pair of data axes); in the backward on the (2, 16, 16) mesh an
    operand DTensor splits in its strided way (a batch-and-heads dim) is
    made whole over that mesh dim first (:func:`_unstrided_product`:
    DTensor's strategy search over strided placements of three mesh dims
    takes minutes a product); the experts' stacked weights
    against the dense MoE path's capacity buffer, which the data axes
    leave whole, are gathered in the forward (but for the output columns
    of a product the model axis contracts: those stay split, and the
    partial sum is reduced at that size), an activation that is a partial
    sum over the data axes is reduced against them, and each data rank
    computes its share of their gradient in their own layout, as GSPMD
    does (DTensor computes it whole on every rank); a trainable matrix's
    gradient (or its transpose) is split as the matrix over each mesh dim
    that splits it and not the contraction (:func:`_as_weight_gradient`:
    the logits' gradient gathered over the vocabulary for an embedding
    split along d, where DTensor computes the embedding's whole
    gradient on every model rank). The backward is autograd's graph task
    with grad mode off; remat's recomputed forward, which runs inside it
    with grad mode on, is laid out as the forward;
  - pointwise operations (``add``, ``sub``, ``mul``, ``div``, ``pow``): a
    partial sum over the model axis that meets an operand that is not one
    is reduced whole, and of two operands the model axis splits along
    different dims the smaller is gathered (:func:`_reduce_partials`),
    where DTensor scatters the partial sum over the batch and then gathers
    every activation that meets it; a partial sum over a data axis that
    holds fewer elements than the result (the dense MoE route's routing
    weights against the experts' output) is reduced first, as torch 2.11
    and GSPMD reduce it (2.13 reduces the product), and one divided by an
    operand that mesh dim splits is reduce-scattered onto that split
    first, as 2.11 does (2.13 gathers the divisor); under sequence
    parallelism DTensor's scatter onto the sequence split stands; an
    activation's backward (``silu_backward``, ``gelu_backward``) reduces
    a partial sum whole first (:func:`_partials_reduced`; 2.13 scatters it
    along another dim);
  - DTensor's unpadding of a gathered uneven split is a view of the
    gathered tensor (:func:`_unpad_as_a_view`), as torch 2.11 leaves it;
    2.13 copies it contiguous;
  - the dense MoE route, on the global batch (the reference's one GSPMD
    program): the ``searchsorted`` of the experts' sorted slots gathers
    the sorted values whole (:func:`_searchsorted_layout`; DTensor's own
    sort gathers the sorted dim), ``index_copy_`` copies into each rank's
    share with the indices whole (:func:`_index_copy_layout`), the router's
    load count (``scatter_add_``) adds each rank's slots and reduces the sum
    (:func:`_scatter_add_layout`); in the backward, the router's top-k
    gradient is scattered into zeros split as the tokens, each rank its
    own rows (:class:`_TopkBackwardLikeInput`, :func:`_scatter_by_rows`),
    as GSPMD and torch 2.13 do (2.11 makes the zeros whole on every rank
    and gathers the tokens' gradients into them), a gather of rows adds
    each rank's rows back (``index_add``, :func:`_index_add_layout`: torch
    2.11's rule meets the whole indices with the split rows) and
    ``index_copy_``'s zeroes the copied rows of each rank's share
    (``index_fill``, :func:`_index_fill_layout`; no rule in torch 2.11);
    the reference's ``_constrain`` of the capacity buffer is
    ``models.moe._constrain``, and where neither E nor C divides the model
    axis (qwen2-moe) the buffer is born split along d as the experts'
    weights split it, the layout GSPMD takes from them
    (``models.moe._buffer_placements``);
  - Mamba-2: the layer runs by heads over the model axis, B and C whole,
    inside the ``shard_map`` boundary (``models.mamba2._mamba2_by_heads``:
    24 heads on 16 ranks give rank 0 two, GSPMD's padded share); a
    decode step's split of the column-split projection into (z, x, B, C,
    dt) keeps each piece the ranks divide split along the columns, as
    GSPMD keeps a slice of a split dim split (:func:`_split_keeping`);
    a one-sequence decode whose model axis splits neither the heads nor
    ``w_in`` (mamba2-130m's ``long_500k``) takes the projection's columns
    over the idle data axes and the state's update and product with C by
    heads, the new state gathered into the cache (the layout hooks
    ``parallel.layouts.columns_over_idle_data``, ``over_model`` and
    ``on_split_heads``; the gather is DTensor's redistribution), where
    DTensor keeps every column on every rank and splits the state along
    N;
  - attention where the model axis divides the query heads and not the
    key heads and leaves the batch whole (a prefill's, a decode's or a
    two-pod step's): the model's layout hook
    ``parallel.layouts.kv_by_query_heads`` gives K and V repeated to the
    query's heads, split over the model axis as q is, each rank
    projecting only its groups' key heads, as GSPMD propagates the query
    heads' split into the projections; DTensor's strategies split the
    batch or nothing (each model rank all the heads);
  - a decode step against a cache the model axis splits along its slots
    (``cache_specs``' rule where it does not divide the KV heads): the
    rank holding the step's slot writes it in place
    (``parallel.layouts.write_slot``; DTensor's ``select`` gathers the
    cache), and the softmax over the slots reduces each rank's max and
    sum (:func:`_split_softmax`; DTensor gathers the logits); where the
    data axes leave the batch whole (``long_500k``), each data rank
    multiplies its share of the query heads' probabilities by the values
    (``parallel.layouts.heads_over_idle_data``), as GSPMD spreads that
    product over them, where DTensor runs every head on every data rank;
    the mask's ``where`` over logits that are a partial sum reduces them
    first (:func:`_partials_reduced`), where DTensor's rule differs between
    torch releases;
  - a decode's attention where the mesh splits q, K and V only along the
    batch and the heads (the MoE archs' 16 key heads on 16 ranks): each
    rank attends on its own rows and heads
    (``parallel.layouts.on_local_heads``), where torch 2.11's ``view``
    gathers the cache over the model axis to merge the two split dims;
  - the default positions, a broadcast ``arange`` the model builds whole
    over the batch, are laid out as the activations' batch
    (``parallel.layouts.split_as_batch``), as GSPMD propagates the batch
    split into them: DTensor computes the rotary angles of the whole
    batch on every rank;
  - the data axes ("pod", "data") of the (2, 16, 16) mesh are flattened
    into one mesh dim of 32 (``DeviceMesh._flatten``), which DTensor's
    redistributions use to reduce or gather over both at once;
  - the logits' constraint onto a vocabulary the model axis does not
    divide (mamba2-130m's 50280, whisper-large-v3's 51866) reduces their
    partial sum whole, in float32, before each rank keeps its share, as
    GSPMD does (``parallel.sharding_constraint``), where DTensor scatters
    the padded sum;
  - each parameter's gradient takes the parameter's layout as autograd
    makes it (:func:`_grad_as_parameter`), not at the optimizer;
  - the loss: the gradient of its mean is split over the data axes along
    the batch (:func:`_expand_over_batch`), gather's backward stays split
    over the vocabulary as the logits are, also in a step that runs per
    data rank (``--grad-sync canary_fp``) (:func:`_zeros_like_source`,
    :func:`_scatter_into_split`), and the logits' ``logsumexp`` reduces
    each rank's share of the vocabulary, its max and its sum each
    all-reduced (:func:`_split_logsumexp`; torch 2.13's ``log`` would
    scatter the sum), and
    the accuracy's ``argmax`` gathers each rank's maximum and its index
    (:func:`_argmax_layout`; a decode's next token too, after its
    logits' partial sum is reduced), each where DTensor gathers or moves
    all of the logits;
  - where torch 2.11's rules fail: ``argmax`` along an unsplit dim
    (:func:`_argmax_layout`), and the embedding's lookup with its indices
    split over two mesh dims, and its backward (:func:`_embedding_lookup`,
    :func:`_embedding_grad`).

  The rows are therefore estimates of an eager DTensor program with these
  layouts, not of what GSPMD compiles: ``tests/test_torch_dryrun.py`` holds
  a small step's FLOPs, temporaries and link bytes to the reference's
  compiled ones (FLOPs equal where both run the same products; the rest
  within stated bounds), and each layout against the operation on whole
  tensors, on gloo ranks.
* ``with_sharding_constraint`` at the period boundaries and on the logits:
  ``models.transformer._activation_constraint`` and
  ``train_step.make_loss_fn``'s ``constrain``, which redistribute a DTensor
  and leave a plain tensor alone; the prefill's logits here, as the
  reference's ``prefill_fn``.
* ``cost_analysis()["flops"]``: ``per_device.flops``, the products and
  attention counted on each operation's local tensors by
  ``torch.utils.flop_counter``'s formulas (the flash custom ops by theirs:
  4 D operations a live (query, key) pair forward, 10 D backward).
  ``FlopCounterMode`` itself, around DTensors, counts global shapes.
* ``cost_analysis()["bytes accessed"]``: ``per_device.bytes_accessed``, the
  input and output bytes of every local operation that moves tensor data:
  not a view, a bare allocation, or an op of ``_UNREAD`` (DTensor's device
  query of a local tensor, a reshape that aliases its input); an op of
  ``_TEMPLATED`` (``new_zeros``, ``zeros_like``, ...) reads of its tensor
  argument only the shape, and counts its output alone. That is what
  eager PyTorch moves with no fusion, not a bound of XLA's fused count:
  the reference's CPU compile carries bf16 activations in float32, so its
  count can be the larger. ``tests/test_torch_dryrun.py`` holds it, less
  the flash calls' bytes (``attention_bytes``), to the reference's
  compiled bytes less the chunked attention's scans.
* ``parse_collective_bytes(hlo)``: ``per_device.collective_bytes`` and
  ``collective_counts`` by the reference's kinds, from the collectives the
  trace makes on groups of more than one rank (DTensor's functional
  collectives and ``torch.distributed``'s): all-reduce, all-gather,
  reduce-scatter and all-to-all by their result's bytes, a point-to-point
  send as a collective-permute of its bytes (the reference's trees are
  ``ppermute``s; the matching receive is not counted again), and
  ``collective_link_bytes`` with the reference's multipliers (all-reduce
  2x, the others 1x). ``reduce_ops`` counts the all-reduces by reduction;
  ``unknown_collectives`` names any other collective op the trace made,
  uncounted, as the reference tallies an HLO dtype it does not know.
* ``memory_analysis()``: ``argument_bytes`` exactly, the local storages of
  the parameters, optimizer state, batch and cache that an operation of
  the step reads (``jax.jit`` drops unused arguments: a decode step reads
  no encoder weight), the decode cache's position a host integer here,
  where the reference's is a 0-d int32;
  ``total_bytes`` the peak of live local storage over the step, tracked
  through every operation's outputs until Python frees them;
  ``temp_bytes`` the peak less the arguments; ``output_bytes`` the storage
  of the step's outputs that is not an argument's (parameters and moments
  are updated in place, so nothing aliases). What the caching allocator
  rounds and what cuBLAS and NCCL hold are not tensors and are not seen.
* ``per_device`` keys: ``hlo_flops`` -> ``flops``, ``hlo_bytes`` ->
  ``bytes_accessed``, ``collectives_scanned_body`` -> ``collective_bytes``,
  ``collective_counts_scanned_body`` -> ``collective_counts``;
  ``raw_scanned_flops`` has no counterpart. ``compile_s`` is the trace's
  wall. ``attention`` records how DTensor laid out each flash call
  (batch, heads, batch+heads or replicated), by pass.
* The private internals of torch that the accounting reaches into are in
  one section, checked by :func:`check_torch` before a run: a torch
  release it was not tried on is refused.
* ``_probe_costs`` / ``extrapolated_costs``: not carried over. They exist
  because XLA's cost analysis counts a ``while`` body once, and the
  reference scans its layers; the port's layers are a Python loop, traced
  in full. So the rows differ where the layouts agree: the reference's
  FLOPs and bytes come from probes of one and two layer periods with
  ``remat=False``, extrapolated over the depth, where the port's row
  counts the step it runs, remat's recomputed forward included; and in a
  probe the reference still counts each remaining ``while`` body once
  (``chunked_attention``'s blocks, the SSD's scan), where the port counts
  every iteration. ``tests/test_torch_dryrun_production.py`` holds one
  unrolled layer period without remat, the reference's probe, to the
  reference's compiled one with each while body counted its trip count.
* ``--save-hlo``: no HLO exists; the flag is not carried over.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import heapq
import json
import os
import sys
import time
import traceback
import weakref
from collections import Counter
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch._subclasses.fake_tensor import FakeTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..models import forward, get_config, init_cache, list_archs
from ..models import Transformer
from ..models.config import ModelConfig
from ..models.layers import torch_dtype
from ..optim import AdamWConfig, AdamWState
from ..parallel import (ParallelContext, batch_spec, cache_specs,
                        get_parallel_context, mesh_shape, param_placements,
                        param_specs, parallel_context, sharding_constraint)
from ..parallel.layouts import contiguous_stride, d_split_kept
from ..parallel.sharding import P
from ..serving import make_serve_step
from ..train import TrainConfig, make_train_step
from ..train.train_step import EXPLICIT_MODES, Mesh
from .analysis import INPUT_SHAPES, model_flops_per_step
from .mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16, PRODUCTION_SHAPES,
                   make_production_mesh, mesh_axes)

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# DTensor's functional collectives and the torch.distributed calls of the
# port's code (the Canary trees' sends, the metrics' and scales'
# all-reduces, the MoE layer's gathers), by kind
_FUNCOL = {"all_reduce": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all"}
# DTensor's own all-to-all of a shard onto another dim (on CUDA meshes; a
# CPU mesh all-gathers and chunks instead)
_DTENSOR = {"shard_dim_alltoall": "all-to-all"}
_C10D = {"allreduce_": "all-reduce", "allgather_": "all-gather",
         "_allgather_base_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_base_": "all-to-all", "send": "collective-permute"}
# ops of the collectives' namespaces that move nothing of their own (a
# receive is counted as its matching send)
_UNMOVED = {"wait_tensor", "_wrap_tensor_autograd", "recv_", "barrier",
            "monitored_barrier_"}
# of those, the op that hands a collective's result back wrapped, holding
# its input's storage (an ``AsyncCollectiveTensor``): its output is counted
# as its input's storage (see :meth:`Accountant.alias`), since the fake
# allocates where the real op does not: ``empty_like(input)`` in the fakes
# of torch 2.11 and 2.13
_WRAPS = {"_wrap_tensor_autograd"}
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided"}
# ops that read of a tensor argument only its shape, dtype and device, and
# write their output: counted by their output's bytes (torch 2.11's topk
# backward makes its zeros with ``zeros``, 2.13's with ``new_zeros``)
_TEMPLATED = {"new_zeros", "new_ones", "new_full", "zeros_like",
              "ones_like", "full_like"}
# ops that read and write no tensor data though torch does not mark them
# views, by namespace: the device query DTensor makes of each local tensor
# (it returns a ``torch.device``), and the reshape that aliases its input
# (its fake shares the input's storage, as the real op does)
_UNREAD = {("prim", "device"), ("aten", "_unsafe_view")}
_FLASH = {"flash_attention_fwd": "fwd", "flash_attention_bwd": "bwd"}
PEAK_LARGEST = 8         # the largest storages live at the peak, reported


# -------------------------------------------------------- torch's internals
# The accounting rests on torch's private internals, all of them in this
# section: the "fake" backend of torch's test utilities; DTensor's local
# tensor, its sharding propagator's shape inference, strategy table and
# cache and local offsets; c10d's group resolution; a storage's identity;
# the caller's frames; autograd's current graph task; the current dispatch
# mode; a device mesh's flattening of two of its dims; DTensor's all-to-all
# of a shard onto another dim. They were tried on the releases below; on
# any other the dry run refuses to run rather than count wrong.
TORCH_TESTED = ("2.11", "2.13")


def check_torch() -> None:
    """Raise unless this torch is one :data:`TORCH_TESTED` names and has
    every internal the accounting uses."""
    from torch.distributed.tensor import _utils as dtensor_utils
    from torch.distributed.tensor import placement_types as dtensor_placements
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    release = ".".join(torch.__version__.split(".")[:2])
    if release not in TORCH_TESTED:
        raise RuntimeError(f"the dry run rests on torch internals tried on "
                           f"torch {', '.join(TORCH_TESTED)}; this is "
                           f"{torch.__version__}")
    prop = DTensor._op_dispatcher.sharding_propagator
    needs = [(ShardingPropagator, "_propagate_tensor_meta_non_cached"),
             (prop, "op_strategy_funcs"), (prop, "propagate_op_sharding"),
             (prop.propagate_op_sharding, "cache_clear"),
             (dist.distributed_c10d, "_resolve_process_group"),
             (dist.ProcessGroup, "unbox"),
             (torch.UntypedStorage, "_cdata"), (sys, "_getframe"),
             (torch._C, "_current_graph_task_id"),
             (torch.utils._python_dispatch, "_get_current_dispatch_mode"),
             (dtensor_utils, "compute_local_shape_and_global_offset"),
             (DeviceMesh, "_flatten"), (torch._prims_common, "infer_size"),
             (dtensor_placements, "shard_dim_alltoall"),
             (torch.ops._dtensor, "shard_dim_alltoall")]
    missing = [f"{getattr(o, '__name__', type(o).__name__)}.{n}"
               for o, n in needs if not hasattr(o, n)]
    if missing:
        raise RuntimeError(f"torch {torch.__version__} lacks the internals "
                           f"the dry run uses: {missing}")


def _register_fake_backend() -> None:
    """Register the ``"fake"`` backend of torch's test utilities with
    ``torch.distributed``."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401


def _storage_key(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its views share it)."""
    return t.untyped_storage()._cdata


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def _offset(t: DTensor, d: int) -> int:
    """Where this rank's share of ``t`` starts along dim ``d`` (DTensor's
    own reckoning, uneven shares included)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)[1][d]


def _group_size(func_name: str, args) -> int:
    if func_name in _FUNCOL or func_name in _DTENSOR:
        name = [a for a in args if isinstance(a, str)][-1]
        return dist.distributed_c10d._resolve_process_group(name).size()
    pg = [a for a in args if isinstance(a, torch.ScriptObject)][0]
    return dist.ProcessGroup.unbox(pg).size()


def _in_backward() -> bool:
    """Whether autograd's backward pass is computing a gradient: inside its
    graph task, with grad mode off. ``torch.utils.checkpoint`` recomputes a
    forward (remat) inside the backward's graph task with grad mode on:
    that is the forward, laid out as the forward."""
    return torch._C._current_graph_task_id() != -1 \
        and not torch.is_grad_enabled()


def _from_torch_distributed() -> bool:
    """Whether the Python code that made the current call is
    ``torch.distributed``'s own (the first frame outside torch's dispatch
    machinery), not the traced step's."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if name.startswith("torch.distributed"):
            return True
        if not name.startswith("torch."):
            return False
        f = f.f_back
    return False


@contextlib.contextmanager
def _shape_inference_uncounted(acct: "Accountant"):
    """Mark DTensor's shape inference while it runs (the operation run
    once more on fake tensors of the global shapes: a fake mode sits below
    every other mode, so it passes through the accountant), so that it is
    not counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def inferring(self, op_schema):
        acct.inferring += 1
        try:
            return real(self, op_schema)
        finally:
            acct.inferring -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = inferring
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = real


@contextlib.contextmanager
def _views_reshard():
    """``view`` and ``_unsafe_view`` (the flattening inside ``einsum`` and
    ``flatten``) take DTensor's ``reshape`` rule where their own refuses a
    split, while the step traces (see the module's docstring); restored
    after, with the sharding cache."""
    prop = DTensor._op_dispatcher.sharding_propagator
    reshape = torch.ops.aten.reshape.default
    views = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
    funcs = prop.op_strategy_funcs
    if reshape not in funcs or any(v not in funcs for v in views):
        raise RuntimeError("DTensor registers no strategy for aten.view, "
                           "aten._unsafe_view or aten.reshape in this torch")
    resharding = funcs[reshape]
    real = {v: funcs[v] for v in views}

    def or_reshard(rule):
        def view_or_reshard(op_schema):
            try:
                return rule(op_schema)
            except RuntimeError:      # a split the view rule refuses
                return resharding(op_schema)
        return view_or_reshard

    for v in views:
        funcs[v] = or_reshard(real[v])
    prop.propagate_op_sharding.cache_clear()
    try:
        yield
    finally:
        funcs.update(real)
        prop.propagate_op_sharding.cache_clear()


def _merged_groups(src, dst) -> List[List[int]]:
    """The groups of dims of shape ``src`` that a view to shape ``dst``
    merges into one dim (the (E, C) of (E, C, d) -> (E C, d)), each with its
    dims of more than one element only; ``[]`` where the view does not
    only merge and split."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        group, a, b = [i], src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b and i < len(src):
                group.append(i)
                a, i = a * src[i], i + 1
            elif b < a and j < len(dst):
                b, j = b * dst[j], j + 1
            else:
                return []
        group = [d for d in group if src[d] != 1]
        if len(group) > 1:
            groups.append(group)
    return groups


def _flatten_gathered(func):
    """``func`` (``view``, ``_unsafe_view``, ``reshape``) of a DTensor that
    a mesh dim splits along a dim the view merges behind a dim no mesh dim
    splits (the capacity C of the dense MoE route's (E, C, d) -> (E C, d)):
    that dim gathered (all-gather and concatenate, DTensor's
    redistribution), then flattened on each rank, as torch 2.11 and GSPMD
    do; the rule of torch 2.13 that :func:`_views_reshard` falls back to
    gathers the flattened rows and reorders them with an
    ``index_select``. A group whose first dim is split too (a batch split
    over the data axes merged with heads split over the model axis) is
    left to DTensor, whose strided split keeps both; so is every view under
    sequence parallelism."""
    def layout(x, size, *rest):
        ctx = get_parallel_context()
        if not isinstance(x, DTensor) or rest or ctx is None \
                or ctx.sequence_parallel:
            return NotImplemented
        size = torch._prims_common.infer_size(size, x.numel())
        mesh = x.device_mesh
        split = {p.dim for m, p in enumerate(x.placements)
                 if p.is_shard() and mesh.size(m) > 1}
        behind = {d for g in _merged_groups(tuple(x.shape), tuple(size))
                  if g[0] not in split for d in g[1:]}
        gather = [m for m, p in enumerate(x.placements)
                  if p.is_shard() and p.dim in behind and mesh.size(m) > 1]
        if not gather:
            return NotImplemented
        x = x.detach().redistribute(mesh, [
            Replicate() if m in gather else p
            for m, p in enumerate(x.placements)])
        return func(x, size)
    return layout


@contextlib.contextmanager
def _unpad_as_a_view():
    """DTensor's unpadding of a gathered uneven split (``Shard``'s
    ``_maybe_unpad_tensor``) a narrow, a view of the gathered tensor, as
    torch 2.11 leaves it and as GSPMD slices inside the fusion that reads
    it; torch 2.13 copies it contiguous whatever reads it next (the
    (16, 4096, 3352) projections of mamba2-130m, 107.6 GB of its
    ``train_4k`` row). Restored after; a release with no such method is
    left as it is."""
    real = getattr(Shard, "_maybe_unpad_tensor", None)
    if real is None:
        yield
        return

    def unpad(self, local_tensor, logical_dim_size, num_chunks):
        if local_tensor.size(self.dim) == logical_dim_size:
            return local_tensor
        return local_tensor.narrow(self.dim, 0, logical_dim_size)

    Shard._maybe_unpad_tensor = unpad
    try:
        yield
    finally:
        Shard._maybe_unpad_tensor = real


@contextlib.contextmanager
def _alltoall_as_on_cuda():
    """DTensor's redistribution of a shard onto another dim takes, on a
    CPU mesh, an all-gather and a chunk (gloo has no all-to-all); on a
    CUDA mesh, ``_dtensor.shard_dim_alltoall``. While the step traces,
    a CPU mesh takes the CUDA path too (its fake accepts fake tensors),
    so that the rows of ``--device cpu`` count the card's all-to-all."""
    from torch.distributed.tensor import placement_types
    real = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = real


# ------------------------------------------------------------ process group
@contextlib.contextmanager
def fake_process_group(world: int):
    """A ``"fake"`` default process group of ``world`` ranks, this process
    rank 0: every collective returns at once and moves nothing. Destroyed
    on exit."""
    check_torch()
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the dry run "
                           "starts its own fake one (run it in a process "
                           "with no process group)")
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


# ------------------------------------------------------------- fake inputs
def _fake(shape, dtype, device: str, mesh: DeviceMesh, spec: P
          ) -> torch.Tensor:
    """An empty DTensor of global ``shape`` laid out as ``spec``: each rank
    holds a fake local tensor of its shard's shape. Every rule of the port
    shards only dims its mesh axes divide."""
    placements = param_placements(spec, mesh)
    local = list(shape)
    for m, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(m)
            if local[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"split over {n} ranks ({spec})")
            local[pl.dim] //= n
    t = torch.empty(local, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def _fake_params(cfg: ModelConfig, mesh: DeviceMesh, device: str,
                 specs: Mapping[str, P]) -> Transformer:
    """The model's parameters as fake DTensors laid out by ``specs``."""
    model = Transformer(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(
            _fake(p.shape, p.dtype, device, mesh, specs[name]),
            requires_grad=False))
    return model


def _batch(cfg: ModelConfig, kind: str, seq: int, gb: int, mesh: DeviceMesh,
           bspec: P, device: str) -> Dict[str, torch.Tensor]:
    text = seq - (cfg.num_patches if cfg.frontend == "vision_stub" else 0)
    batch = {"tokens": _fake((gb, text), torch.int32, device, mesh, bspec)}
    if kind == "train":
        batch["labels"] = _fake((gb, text), torch.int32, device, mesh, bspec)
    dt = torch_dtype(cfg.dtype)
    if cfg.frontend == "audio_stub":
        batch["frames"] = _fake((gb, cfg.encoder_seq, cfg.d_model), dt,
                                device, mesh, bspec)
    if cfg.frontend == "vision_stub":
        batch["patches"] = _fake((gb, cfg.num_patches, cfg.d_model), dt,
                                 device, mesh, bspec)
    return batch


def build_dryrun(arch: str, shape_name: Union[str, Mapping[str, Any]],
                 mesh: DeviceMesh, grad_sync: str = "auto",
                 cfg_override: Optional[ModelConfig] = None,
                 microbatches: int = 1, moe_impl: str = "",
                 device: str = "cuda") -> Tuple[Any, Tuple, ModelConfig]:
    """``(fn, args, cfg)``: the step and its fake inputs, ready for
    :func:`account` under the mesh's :class:`ParallelContext`.

    ``shape_name`` is a key of ``INPUT_SHAPES`` or such a dict
    (``kind``, ``seq_len``, ``global_batch``). ``mesh`` is a
    :class:`DeviceMesh` whose axes are ``mesh_axes``'; its process group
    (the fake one of :func:`run_one`) must be up. The inputs are fake
    tensors on ``device`` in a ``FakeTensorMode`` of their own."""
    spec = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else dict(shape_name)
    kind = spec["kind"]
    seq, gb = spec["seq_len"], spec["global_batch"]
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    if moe_impl:
        cfg = cfg.with_(moe_impl=moe_impl)
    dp_axes, model_axis = mesh_axes(mesh)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    if len(dp_axes) > 1:
        # DTensor then reduces or gathers over ("pod", "data") at once,
        # as one group of 32, where it would go one mesh dim after the
        # other (twice an all-reduce's bytes, 1.5 times an all-gather's)
        mesh[dp_axes]._flatten()
    sizes = mesh_shape(mesh)
    if kind == "decode" and shape_name == "long_500k":
        if not cfg.supports_long_decode():
            raise ValueError(f"{arch} skips long_500k (see DESIGN.md §5)")
        cfg = cfg.long_context_variant(window=8192)

    from torch._subclasses.fake_tensor import FakeTensorMode
    # DTensor's host arithmetic of shard offsets makes small real CPU
    # tensors (see :class:`Accountant`), which may meet the fake ones
    with FakeTensorMode(allow_non_fake_inputs=True):
        if kind == "train":
            return _build_train(cfg, mesh, sizes, dp, dp_axes, model_axis,
                                seq, gb, grad_sync, microbatches, device)
        params = _fake_params(cfg, mesh, device, param_specs(
            Transformer(cfg, device="meta"), sizes, fsdp=dp,
            model=model_axis))
        bspec = batch_spec(sizes, gb, dp)
        if kind == "prefill":
            def prefill_fn(params, batch):
                kw = {}
                if "frames" in batch:
                    kw["frames"] = batch["frames"]
                if "patches" in batch:
                    kw["extra_embeds"] = batch["patches"]
                with torch.no_grad():
                    logits, _ = forward(params, batch["tokens"], cfg, **kw)
                return sharding_constraint(logits, P(dp, None, model_axis),
                                           mesh)

            batch = _batch(cfg, kind, seq, gb, mesh, bspec, device)
            return prefill_fn, (params, batch), cfg

        # decode: shapes of the cache from init_cache, made fake
        shapes = init_cache(cfg, gb, seq, device="cpu")
        c_specs = cache_specs(shapes, sizes, dp_axes=dp, model=model_axis)

        def fake_tree(node, sp):
            if isinstance(node, Mapping):
                return {k: fake_tree(v, sp[k]) for k, v in node.items()}
            if isinstance(node, list):
                return [fake_tree(v, s) for v, s in zip(node, sp)]
            if isinstance(node, torch.Tensor):
                return _fake(node.shape, node.dtype, device, mesh, sp)
            return node                          # the host position

        cache = fake_tree(shapes, c_specs)
        tokens = _fake((gb, 1), torch.int32, device, mesh, bspec)

        step = make_serve_step(cfg)

        def serve(params, cache, tokens):
            with torch.no_grad():
                return step(params, cache, tokens)

        return serve, (params, cache, tokens), cfg


def _build_train(cfg, mesh, sizes, dp, dp_axes, model_axis, seq, gb,
                 grad_sync, microbatches, device):
    oc = AdamWConfig(state_dtype="bfloat16" if cfg.param_count() > 1e11
                     else "float32")
    tc = TrainConfig(model=cfg, optimizer=oc, grad_sync=grad_sync,
                     microbatches=microbatches)
    meta = Transformer(cfg, device="meta")
    if grad_sync == "auto":
        p_specs = param_specs(meta, sizes, fsdp=dp, model=model_axis)
        on, step = mesh, make_train_step(tc)
        bspec = batch_spec(sizes, gb, dp)
    elif grad_sync in EXPLICIT_MODES:
        # per data rank, as the reference's data-manual shard_map: the
        # model axis's mesh, parameters replicated over the data axes
        p_specs = param_specs(meta, sizes, fsdp=dp, model=model_axis,
                              use_fsdp=False)
        data = _world(tuple(sizes[a] for a in dp_axes))
        if gb % data:
            raise ValueError(f"global batch {gb} does not split over "
                             f"{data} data ranks")
        gb //= data
        on = mesh[model_axis]
        groups = tuple(mesh.get_group(a) for a in dp_axes)
        step = make_train_step(tc, mesh=Mesh(
            inner=groups[-1], outer=groups[0] if len(groups) > 1 else None))
        bspec = P(None)
    else:
        raise ValueError(f"unknown grad_sync {grad_sync}")
    params = _fake_params(cfg, on, device, p_specs)
    for p in params.parameters():       # value_and_grad turns them on too
        p.requires_grad_(True)
        p.register_hook(functools.partial(_grad_as_parameter, p))
    sd = torch_dtype(oc.state_dtype)

    def moments():
        return {n: _fake(p.shape, sd, device, on, p_specs[n])
                for n, p in params.named_parameters()}

    opt = AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=moments(), v=moments())
    batch = _batch(cfg, "train", seq, gb, on, bspec, device)
    return step, (params, opt, batch), cfg


def _grad_as_parameter(p, g):
    """A parameter's gradient laid out as the parameter as soon as autograd
    makes it (a reduce-scatter of each layer's partial sums as its backward
    ends), as GSPMD propagates a parameter's sharding to its gradient and
    FSDP reduces layer by layer; DTensor alone keeps every layer's whole
    partial gradient until the optimizer."""
    return g.redistribute(p.device_mesh, p.placements) \
        if isinstance(g, DTensor) else g


# --------------------------------------------------------------- accounting
def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nest of modules, mappings, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, Mapping):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x: Any) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


_REDUCE_OPS = {int(getattr(dist.ReduceOp, n)): n.lower()
               for n in ("SUM", "AVG", "PRODUCT", "MIN", "MAX")}


class Accountant(TorchDispatchMode):
    """Counts what one rank does, on its local tensors. It declines every
    DTensor-level call, so DTensor's own local operations and collectives
    come back through it.

    No fake mode is active around the trace: an operation on fake tensors
    goes to their fake mode by itself. A call that makes a tensor from
    nothing runs in ``fake_mode``, except on the meta device (a model
    built only for its names, as AdamW's decay rule builds one) and
    DTensor's host arithmetic of shard sizes and offsets (small CPU
    tensors it reads back as integers), which run for real and, as every
    operation on real tensors only, are not counted. ``weights``: the
    step's arguments, whose trainable matrices and stacked weights (the
    experts') :func:`_gather_weight` lays their gradients out as."""

    def __init__(self, fake_mode, weights=()):
        super().__init__()
        self.fake_mode = fake_mode
        # {global shape: placements} of the trainable 2-d and 3-d weights
        # (and of each matrix's transpose), a shape two layouts share left
        # out
        layouts: Dict[Tuple[int, ...], set] = {}
        for t in weights:
            if not (isinstance(t, DTensor) and t.ndim in (2, 3)
                    and t.requires_grad):
                continue
            layouts.setdefault(tuple(t.shape), set()).add(tuple(t.placements))
            if t.ndim == 2:
                layouts.setdefault(tuple(t.shape)[::-1], set()).add(tuple(
                    Shard(1 - p.dim) if p.is_shard() else p
                    for p in t.placements))
        self.weights = {s: next(iter(p)) for s, p in layouts.items()
                        if len(p) == 1}
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = dict.fromkeys(_COLLECTIVES, 0)
        self.coll_counts = dict.fromkeys(_COLLECTIVES, 0)
        self.reduce_ops: Counter = Counter()
        self.unknown: Counter = Counter()
        self.attention: Dict[str, Counter] = {"fwd": Counter(),
                                              "bwd": Counter()}
        # the flash ops' FLOPs, and what attention that issues every
        # (query, key) pair with the forward's probabilities kept (the
        # reference's chunked_attention: 2 products forward, 4 backward)
        # would count for the same calls
        self.attention_flops = {"kernel": 0, "all_pairs": 0}
        self.attention_bytes = 0    # of ``bytes``, the flash ops'
        self.inferring = 0          # inside DTensor's shape inference
        self.live = 0               # bytes of local storage alive
        self.peak = 0
        # each storage counted: {record: (bytes, origin, shape, dtype)}; the
        # live storages that hold a record (its own and its wraps'), by
        # storage key, and how many hold each
        self._storages: Dict[int, Tuple] = {}
        self._holder: Dict[int, int] = {}
        self._holders: Counter = Counter()
        self._records = 0
        self._peak_dirty = False
        self.at_peak: List[Tuple] = []     # see live_at_peak
        self._global_q: Optional[Tuple[int, ...]] = None
        self.read: set = set()      # the storages an operation has read

    # -- storage
    def track(self, t: torch.Tensor, origin: str = "argument") -> int:
        """Count ``t``'s storage live until it is freed; its bytes if new.
        ``origin`` names what made it, for :meth:`live_at_peak`."""
        st = t.untyped_storage()
        key = _storage_key(t)
        if key in self._holder:
            return 0
        n = st.nbytes()
        record = self._records = self._records + 1
        self._storages[record] = (n, origin, tuple(t.shape), str(t.dtype))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
            self._peak_dirty = True
        self._hold(st, key, record)
        return n

    def alias(self, t: torch.Tensor, of: torch.Tensor) -> None:
        """Count ``t``'s storage as ``of``'s (a tracked one): no new bytes,
        ``of``'s live until the last of the two is freed."""
        self._hold(t.untyped_storage(), _storage_key(t),
                   self._holder[_storage_key(of)])

    def _hold(self, st, key: int, record: int) -> None:
        self._holder[key] = record
        self._holders[record] += 1
        weakref.finalize(st, self._free, key, record)

    def _free(self, key: int, record: int) -> None:
        if self._holder.get(key) == record:
            del self._holder[key]
        self._holders[record] -= 1
        if self._holders[record]:
            return
        del self._holders[record]
        if self._peak_dirty:    # what is live at the peak, before one goes
            self.at_peak = list(self._storages.values())
            self._peak_dirty = False
        self.live -= self._storages.pop(record)[0]

    def live_at_peak(self) -> List[Tuple]:
        """``(bytes, origin, shape, dtype)`` of every storage live at the
        peak."""
        return list(self._storages.values()) if self._peak_dirty \
            else self.at_peak

    # -- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if func in _LAYOUTS and not self.inferring:
                with self:
                    out = _LAYOUTS[func](*args, **kwargs)
                if out is not NotImplemented:
                    return out
            if func._overloadpacket.__name__ in _FLASH:
                self._global_q = tuple(args[0].shape)
            return NotImplemented
        if self.inferring:
            return func(*args, **kwargs)
        flat = _tensors(list(args) + list(kwargs.values()))
        if not flat:            # a tensor made from nothing
            where = torch.device(kwargs.get("device") or "cpu").type
            if where == "meta" or (where == "cpu"
                                   and _from_torch_distributed()):
                return func(*args, **kwargs)    # holds no bytes of the step
            with self.fake_mode:
                out = func(*args, **kwargs)
            self._count(func, args, kwargs, out)
            return out
        if not any(isinstance(t, FakeTensor) for t in flat):
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default:
            with self:          # as FlopCounterMode: count what it decomposes to
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        flops = flop_registry[packet](*args, **kwargs, out_val=out) \
            if packet in flop_registry else 0
        self.flops += flops
        if name in _FLASH:
            self._layout(name, tuple(args[0].shape))
            (b, h, sq, d), sk = args[0].shape, args[1].shape[2]
            self.attention_flops["kernel"] += flops
            self.attention_flops["all_pairs"] += \
                (4 if _FLASH[name] == "fwd" else 8) * b * h * sq * sk * d
        ins, outs = _tensors(list(args) + list(kwargs.values())), \
            _tensors(out)
        ns = getattr(func, "namespace", "")
        if ns == "_c10d_functional" and name in _WRAPS:
            self.alias(outs[0], ins[0])     # moves nothing, reads nothing
            return
        if not func.is_view:
            self.read.update(_storage_key(t) for t in ins)
        for t in outs:
            self.track(t, str(packet))
        if ns == "_c10d_functional" and name in _FUNCOL:
            self._collective(_FUNCOL[name], name, args, outs)
        elif ns == "c10d" and name in _C10D:
            self._collective(_C10D[name], name, args, _tensors(args[0]))
        elif ns == "_dtensor" and name in _DTENSOR:
            self._collective(_DTENSOR[name], name, args, outs)
        elif ns in ("_c10d_functional", "c10d") and name not in _UNMOVED:
            self.unknown[name] += 1     # a collective not counted: reported
        if func.is_view or name in _ALLOCATIONS or not (ins or outs) \
                or (ns, name) in _UNREAD:
            return
        moved = sum(_nbytes(t) for t in (outs if name in _TEMPLATED
                                         else ins + outs))
        self.bytes += moved
        if name in _FLASH:
            self.attention_bytes += moved

    def _collective(self, kind, name, args, payload) -> None:
        if _group_size(name, args) <= 1:
            return
        self.coll_bytes[kind] += sum(_nbytes(t) for t in payload)
        self.coll_counts[kind] += 1
        if kind == "all-reduce":
            op = args[1] if name in _FUNCOL else _REDUCE_OPS.get(
                args[2].op(), "?")
            self.reduce_ops[str(op)] += 1

    def _layout(self, name: str, local: Tuple[int, ...]) -> None:
        g, self._global_q = self._global_q or local, None
        split = [what for what, d in (("batch", 0), ("heads", 1))
                 if local[d] < g[d]]
        self.attention[_FLASH[name]]["+".join(split) or "replicated"] += 1

    def link_bytes(self) -> float:
        return float(sum(v * (2.0 if k == "all-reduce" else 1.0)
                         for k, v in self.coll_bytes.items()))


# ------------------------------------------------- layouts the dry run gives
def _product_placement(pa, pb, nd: int):
    """The placement of ``a @ b`` (``nd``-dim operands) over one mesh dim
    where ``a``'s is ``pa`` and ``b``'s ``pb`` and neither needs moving;
    ``None`` where one would."""
    rows, feats = nd - 2, nd - 1
    if pa.is_replicate() and pb.is_replicate():
        return Replicate()
    if pa.is_shard(rows) and pb.is_replicate():
        return Shard(rows)
    if pa.is_replicate() and pb.is_shard(feats):
        return Shard(feats)
    if pa.is_shard(feats) and pb.is_shard(rows):
        return Partial()
    if nd == 3 and pa.is_shard(0) and pb.is_shard(0):
        return Shard(0)
    return None


def _gather_weight(a, b):
    """``a @ b`` (``mm``, ``bmm``) of an activation ``a`` and a weight
    ``b``, laid out as FSDP and Megatron (and GSPMD) do over each mesh dim
    that splits ``b`` off its batch dim. Over a data axis that also splits
    ``a``'s tokens, ``b`` is gathered (FSDP: the weight gathered, the
    tokens kept split). Over the model axis, where it splits ``b``'s output
    columns, ``a`` is made whole (Megatron's column-parallel input: its
    tokens or features gathered, a partial sum reduced); a weight dim the
    model axis splits together with the data axes that gather it (FSDP
    over the whole mesh, as the rules place ``wq`` and ``wo`` where the
    heads do not divide the model axis) is gathered over it too, as GSPMD
    does. DTensor's own choice, the cheapest redistribution of the inputs
    by its cost model,
    may instead gather the tokens over the data axes, or gather the weight
    and leave an output of every column to be moved after. In the backward
    pass, the gradient of a column-parallel input (its features and the
    weight's rows split over the model axis, unless the sequence is) is
    reduced whole at once, Megatron's all-reduce, where DTensor scatters
    the partial sum over the batch; so is, in the forward too, a product
    whose contraction the model axis splits with the data axes (an
    encoder-decoder's cross-attention query). Under
    ``parallel.layouts.keep_d_split`` the output columns such a weight
    splits keep the model axis's share, and a step whose tokens hold
    fewer bytes than the weight's share moves the tokens over the data
    axes instead of the weight (the output's tokens split back after).

    A batched product of a stack of weights, one a batch entry (the
    experts' (E, d, f)), against an operand a data axis leaves whole (the
    dense MoE path's capacity buffer, whole over the data axes by the
    reference's constraint) is laid out as GSPMD lays out that program:
    the forward gathers the weight, but for the output columns of a
    product whose contraction the model axis splits (its partial sum is
    then reduced at that size); the backward keeps the weight's split
    where it splits the output's columns (each rank its share of the
    input's gradient), reducing an operand that is a partial sum over the
    data axes, and gathers it where it splits the contraction. A
    product of two operands a data axis leaves whole whose output has the
    shape of a stacked weight the step trains is that weight's gradient:
    each rank computes its share, in the weight's layout (DTensor computes
    it whole on every rank); against a partial sum over the data axes, the
    partial sum is reduced and the operand's split kept. In the backward,
    a sum over the tokens whose output has a trainable matrix's shape is
    that matrix's gradient, laid out by :func:`_as_weight_gradient`.
    ``NotImplemented`` where none of these holds."""
    ctx = get_parallel_context()
    if ctx is None or not isinstance(a, DTensor) \
            or not isinstance(b, DTensor):
        return NotImplemented
    if a.device_mesh.ndim > 2 and _in_backward() and any(
            _strided(p) for p in a.placements + b.placements):
        return _unstrided_product(a, b)
    rows, feats, mesh = a.ndim - 2, a.ndim - 1, a.device_mesh
    names = mesh.mesh_dim_names or ()
    stacked = a.ndim == 3 and a.shape[0] > 1
    backward = _in_backward()
    weight = _weight_layout((a.shape[0], a.shape[1], b.shape[-1])) \
        if stacked else None
    tokens = any(names[m] in ctx.data_axes and mesh.size(m) > 1
                 and pa.is_shard(1) and pb.is_shard(0)
                 for m, (pa, pb) in enumerate(zip(a.placements,
                                                  b.placements)))
    if backward and a.ndim == 2 and tokens:   # a sum over the tokens
        grad = _weight_layout((a.shape[0], b.shape[1]))
        if grad is not None:
            out = _as_weight_gradient(a, b, grad)
            if out is not NotImplemented:
                return out
    model = names.index(ctx.model_axis) if ctx.model_axis in names else None
    # the model axis splits the contraction: a partial sum over it
    row_parallel = model is not None and mesh.size(model) > 1 \
        and a.placements[model].is_shard(feats) \
        and b.placements[model].is_shard(b.ndim - 2)
    gather_a, gather_b, split_a, split_b, reduce = [], [], [], [], []
    move_a = []
    for m, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        data = names[m] in ctx.data_axes
        if mesh.size(m) == 1:
            continue
        if data and weight is not None and pa.is_replicate() \
                and pb.is_replicate():      # the weight's gradient, a^T @ g
            if weight[m].is_shard(rows):
                split_a.append(m)
            elif weight[m].is_shard(feats):
                split_b.append(m)
            continue
        if data and weight is not None and pa.is_shard(rows) \
                and pb.is_partial():    # a stacked weight's gradient
            gather_b.append(m)      # the partial sum reduced, a kept split
            continue
        if not pb.is_shard() or pb.dim == b.ndim - 3:
            continue
        if data and pa.is_shard(feats) and pb.dim == b.ndim - 2 \
                and not backward and not stacked:
            reduce.append(m)        # d split over idle data ranks: summed
            continue
        if data and pa.is_shard(rows):
            if d_split_kept() and not (stacked or backward) \
                    and _nbytes(a.to_local()) < _nbytes(b.to_local()):
                move_a.append(m)    # the tokens move, not the weight
            else:
                gather_b.append(m)
        elif data and stacked and pa.is_replicate():
            if pb.dim == b.ndim - 2 or not (backward or row_parallel):
                gather_b.append(m)
        elif data and stacked and pa.is_partial() and pb.dim == b.ndim - 1:
            gather_a.append(m)      # reduced, the weight's split kept
        elif names[m] == ctx.model_axis and pb.dim == b.ndim - 1 and (
                pa.is_partial() or pa.is_shard(rows) or pa.is_shard(feats)):
            gather_a.append(m)
        elif names[m] == ctx.model_axis and pa.is_replicate() and any(
                n in gather_b and q.is_shard(pb.dim)
                for n, q in enumerate(b.placements)) and not (
                    d_split_kept() and pb.dim == b.ndim - 1):
            gather_b.append(m)      # a dim FSDP splits with the data axes
        elif names[m] == ctx.model_axis and pa.is_shard(feats) \
                and pb.dim == b.ndim - 2 and not ctx.sequence_parallel and (
                    backward or any(n in gather_b and q.is_shard(pb.dim)
                                    for n, q in enumerate(b.placements))):
            reduce.append(m)
    pa = [Replicate() if m in gather_a else Shard(rows) if m in split_a
          else p for m, p in enumerate(a.placements)]
    pb = [Replicate() if m in gather_b else Shard(b.ndim - 1) if m in split_b
          else p for m, p in enumerate(b.placements)]
    for m in move_a:    # the weight's split kept: a matches it
        pa[m] = Shard(feats) if b.placements[m].is_shard(b.ndim - 2) \
            else Replicate()
    for m, (x, y) in enumerate(zip(pa, pb)):
        if move_a and x.is_shard(feats) and y.is_replicate():
            pb[m] = Shard(b.ndim - 2)       # sliced where it is whole
    out = [_product_placement(x, y, a.ndim) for x, y in zip(pa, pb)]
    if None in out:     # the reduction is left to DTensor's rule
        reduce = []
        if move_a:
            return NotImplemented
    if not (gather_a or gather_b or split_a or split_b or reduce or move_a):
        return NotImplemented
    # below autograd already; detached, so that redistribute's autograd
    # Function, run in the backward pass on a weight that needs a gradient,
    # does not detach_ its output (DTensor 2.11 has no rule for detach_)
    a = a.detach().redistribute(mesh, pa)
    b = b.detach().redistribute(mesh, pb)
    product = torch.ops.aten.bmm.default if a.ndim == 3 \
        else torch.ops.aten.mm.default
    if move_a:          # the output's tokens split back over the data axes
        shape = tuple(a.shape[:-1]) + (b.shape[-1],)
        y = _dtensor(product(a.to_local(), b.to_local()), a, out, shape)
        return y.redistribute(mesh, [
            Shard(rows) if m in move_a else Replicate() if m in reduce else p
            for m, p in enumerate(out)])
    if not reduce:
        return product(a, b)
    # the product on each rank's shares, then its partial sum reduced
    shape = tuple(a.shape[:-1]) + (b.shape[-1],)
    return _dtensor(product(a.to_local(), b.to_local()), a, out, shape
                    ).redistribute(mesh, [Replicate() if m in reduce else p
                                          for m, p in enumerate(out)])


def _strided(p) -> bool:
    """Whether ``p`` is DTensor's ``_StridedShard`` (a dim merged from two
    split dims: the batch split over the data axes, the heads over the
    model axis)."""
    return type(p).__name__ == "_StridedShard"


def _unstrided_product(a, b):
    """``a @ b`` in the backward pass where a mesh dim of a mesh of three
    splits an operand in DTensor's strided way (the gradients of an
    attention's batch-and-heads dim, merged from the batch split over
    ("pod", "data") and the heads over "model"): that operand is made
    whole over that mesh dim first. DTensor's search for a strategy over
    such placements of the (2, 16, 16) mesh takes minutes a product (the
    forward's are quick, and laid out by DTensor: a decode's cache stays
    split)."""
    mesh = a.device_mesh
    a, b = (t.detach().redistribute(mesh, [Replicate() if _strided(p)
                                           else p for p in t.placements])
            for t in (a, b))
    product = torch.ops.aten.bmm.default if a.ndim == 3 \
        else torch.ops.aten.mm.default
    return product(a, b)


def _as_weight_gradient(a, b, want):
    """``a @ b`` in the backward pass, a sum over the tokens the data axes
    split whose output has the shape of a trainable matrix (or of its
    transpose): the matrix's gradient, split as the matrix (``want``) over
    each mesh dim that splits the matrix and not the contraction, as GSPMD
    carries a parameter's sharding to its gradient: the operand that holds
    the matrix's split dim split there, the other whole (the logits'
    gradient gathered over the vocabulary for an embedding the model axis
    splits along d). Over a mesh dim that splits the contraction the
    partial sum stands, for the gradient's reduction
    (:func:`_grad_as_parameter`), and over one that leaves the matrix whole
    the product is laid out as the operands are (a replicated weight
    split for its product, Mamba-2's ``w_in``, has its gradient split as
    that product was). ``NotImplemented`` where nothing would move."""
    mesh = a.device_mesh
    pa, pb = list(a.placements), list(b.placements)
    for m, p in enumerate(want):
        if mesh.size(m) == 1 or p.is_replicate() \
                or (pa[m].is_shard(1) and pb[m].is_shard(0)):
            continue
        pa[m], pb[m] = (Shard(0) if p.is_shard(0) else Replicate(),
                        Shard(1) if p.is_shard(1) else Replicate())
    if pa == list(a.placements) and pb == list(b.placements):
        return NotImplemented
    return torch.ops.aten.mm.default(a.detach().redistribute(mesh, pa),
                                     b.detach().redistribute(mesh, pb))


def _weight_layout(shape) -> Optional[Tuple]:
    """The placements of the weight (or matrix transposed) of global
    ``shape`` that the step being counted trains, if any
    (:class:`Accountant`)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    acct = _get_current_dispatch_mode()
    return acct.weights.get(tuple(shape)) \
        if isinstance(acct, Accountant) else None


def _embedding_lookup(table, indices):
    """``table[idx]``, the embedding lookup, on DTensors. Where one mesh
    dim splits the vocabulary and not the indices, each rank looks up the
    rows it holds and zeroes the rest: a partial sum over that dim (as
    DTensor's masked embedding does); where the indices are split too, the
    table is gathered there. ``NotImplemented`` for any other indexing."""
    if len(indices) != 1 or not isinstance(indices[0], DTensor) \
            or not isinstance(table, DTensor):
        return NotImplemented
    idx, mesh = indices[0], table.device_mesh
    vocab_dims = [m for m, t in enumerate(table.placements)
                  if t.is_shard() and t.dim == 0]
    tp, out, masked = [], [], None
    for m, (t, i) in enumerate(zip(table.placements, idx.placements)):
        if t.is_shard() and t.dim == 0 and len(vocab_dims) == 1 \
                and not i.is_shard():
            masked = m
            tp.append(t), out.append(Partial())
            continue
        if t.is_partial() or (t.is_shard() and (t.dim == 0 or i.is_shard())):
            t = Replicate()
        tp.append(t)
        out.append(i if i.is_shard() else Shard(idx.ndim + t.dim - 1)
                   if t.is_shard() else Replicate())
    rows = table.redistribute(mesh, tp).to_local()
    ids = idx.to_local()
    if masked is None:
        local = torch.ops.aten.index.Tensor(rows, [ids])
    else:           # this rank's vocabulary: [lo, lo + len(rows))
        lo = mesh.get_coordinate()[masked] * rows.shape[0]
        ids = ids - lo
        keep = (ids >= 0) & (ids < rows.shape[0])
        local = torch.ops.aten.index.Tensor(rows, [ids * keep])
        local = local * keep.reshape(keep.shape + (1,) * (rows.ndim - 1)
                                     ).to(local.dtype)
    shape = torch.Size(tuple(idx.shape) + tuple(table.shape[1:]))
    return DTensor.from_local(local, mesh, out, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def _embedding_grad(dest, indices, values, accumulate=False):
    """``dest.index_put([idx], values, accumulate=True)``, the embedding
    lookup's backward, on DTensors: where the indices' rows are split, each
    rank adds its rows' values (a partial sum); where the values' features
    are split, so is the result's; else replicated. ``NotImplemented`` for
    any other ``index_put``."""
    if not accumulate or len(indices) != 1 or not all(
            isinstance(t, DTensor) for t in (dest, indices[0], values)):
        return NotImplemented
    idx, mesh = indices[0], dest.device_mesh
    k = idx.ndim
    dp, ip, vp = [], [], []
    for i, v in zip(idx.placements, values.placements):
        rows = i.dim if i.is_shard() else v.dim \
            if v.is_shard() and v.dim < k else None
        if rows is not None:            # this rank's rows
            dp.append(Partial()), ip.append(Shard(rows)), \
                vp.append(Shard(rows))
        elif v.is_shard():              # a feature dim of the values
            dp.append(Shard(v.dim - k + 1)), ip.append(Replicate()), \
                vp.append(v)
        elif v.is_partial():
            dp.append(Partial()), ip.append(Replicate()), vp.append(v)
        else:
            dp.append(Replicate()), ip.append(Replicate()), \
                vp.append(Replicate())
    # dest as a partial sum: whole on the ranks at coordinate 0 of the
    # partial mesh dims, zero on the others (DTensor's redistribute turns
    # nothing into a partial)
    base = dest.redistribute(mesh, [Replicate() if p.is_partial() else p
                                    for p in dp]).to_local()
    coord = mesh.get_coordinate()
    if any(p.is_partial() and coord[m] for m, p in enumerate(dp)):
        base = torch.zeros_like(base)
    local = torch.ops.aten.index_put.default(
        base, [idx.redistribute(mesh, ip).to_local()],
        values.redistribute(mesh, vp).to_local(), True)
    return DTensor.from_local(local, mesh, dp, run_check=False,
                              shape=dest.shape, stride=dest.stride())


def _zeros_like_source(src, size, dtype=None, layout=None, device=None,
                       pin_memory=None):
    """``src.new_zeros(size)`` on a DTensor (the start of ``gather``'s
    backward, ``grad.new_zeros(input.shape)``): split as ``src`` is where a
    dim of ``size`` has ``src``'s extent; and under a context whose model
    axis the mesh has, the last dim ``src`` holds one entry of (the
    gathered dim: the logits' vocabulary) split over the model axis, as
    the logits the gather read are (:func:`_scatter_into_split` then adds
    each rank's entries), also in a step that runs per data rank without
    constraining its activations (``--grad-sync canary_fp``). DTensor
    replicates the zeros whole: the (B, S, V) float32 logits on every
    rank, 32 GiB of llama3.2-1b's at 16 sequences of 4096 tokens."""
    if not isinstance(src, DTensor) or len(size) != src.ndim:
        return NotImplemented
    mesh, shape = src.device_mesh, list(size)
    placements = []
    for m, p in enumerate(src.placements):
        keep = p.is_shard() and size[p.dim] == src.shape[p.dim] \
            and shape[p.dim] % mesh.size(m) == 0
        placements.append(p if keep else Replicate())
        if keep:
            shape[p.dim] //= mesh.size(m)
    ctx = get_parallel_context()
    if ctx is not None and ctx.model_axis in (mesh.mesh_dim_names or ()):
        m = mesh.mesh_dim_names.index(ctx.model_axis)
        gathered = [d for d in range(src.ndim)
                    if src.shape[d] == 1 < size[d]
                    and shape[d] % mesh.size(m) == 0]
        if gathered and mesh.size(m) > 1 and placements[m].is_replicate():
            placements[m] = Shard(gathered[-1])
            shape[gathered[-1]] //= mesh.size(m)
    local = src.to_local().new_zeros(shape, dtype=dtype or src.dtype)
    size = torch.Size(size)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=size, stride=contiguous_stride(size))


def _scatter_into_split(dest, dim, index, src):
    """``dest.scatter_add(dim, index, src)`` on DTensors where one mesh dim
    splits ``dest`` along ``dim`` and splits neither ``index`` nor ``src``
    there (the end of ``gather``'s backward into the vocabulary-split
    zeros): each rank adds the entries whose index falls in its share.
    ``NotImplemented`` otherwise."""
    if not all(isinstance(t, DTensor) for t in (dest, index, src)):
        return NotImplemented
    d, mesh = dim % dest.ndim, dest.device_mesh
    split = [m for m, p in enumerate(dest.placements)
             if p.is_shard(d) and mesh.size(m) > 1]
    if len(split) != 1 or any(p.is_shard(d) for t in (index, src)
                              for p in t.placements):
        return NotImplemented
    m = split[0]
    others = [Replicate() if i == m else p
              for i, p in enumerate(dest.placements)]
    ids = index.redistribute(mesh, others).to_local()
    vals = src.redistribute(mesh, others).to_local()
    base = dest.to_local()
    ids = ids - mesh.get_coordinate()[m] * base.shape[d]
    keep = (ids >= 0) & (ids < base.shape[d])
    local = torch.ops.aten.scatter_add.default(
        base, d, ids * keep, vals * keep.to(vals.dtype))
    return DTensor.from_local(local, mesh, dest.placements, run_check=False,
                              shape=dest.shape, stride=dest.stride())


def _scatter_by_rows(dest, dim, index, src):
    """``dest.scatter(dim, index, src)`` on DTensors that the mesh splits
    alike, along dims other than ``dim`` and with the same extent there
    (top-k's gradient into zeros split as the tokens, the router's
    backward): each rank scatters its own rows, as GSPMD and torch 2.13
    do. ``NotImplemented`` otherwise (DTensor's rule stands)."""
    if not all(isinstance(t, DTensor) for t in (dest, index, src)):
        return NotImplemented
    d = dim % dest.ndim
    split = [p for p in dest.placements if not p.is_replicate()]
    if not split or not dest.placements == index.placements \
            == src.placements or index.shape != src.shape \
            or any(p.is_partial() or p.dim == d
                   or index.shape[p.dim] != dest.shape[p.dim]
                   for p in split):
        return NotImplemented
    local = torch.ops.aten.scatter.src(dest.to_local(), d, index.to_local(),
                                       src.to_local())
    return DTensor.from_local(local, dest.device_mesh, dest.placements,
                              run_check=False, shape=dest.shape,
                              stride=dest.stride())


class _TopkGradientLikeInput(torch.autograd.Function):
    """``torch.topk`` whose backward scatters the values' gradient into
    ``grad.new_zeros`` of the input's shape, the op torch 2.13's top-k
    backward starts from (:func:`_zeros_like_source` lays it out as the
    gradient, split as the tokens); torch 2.11 starts from a factory's
    ``zeros``, whole on every rank, and gathers the tokens' gradients into
    it. The values are the same bits (top-k's indices are distinct within
    a row, so each position is written once)."""

    @staticmethod
    def forward(ctx, x, k, dim, largest, sorted):
        values, indices = torch.topk(x, k, dim, largest, sorted)
        ctx.mark_non_differentiable(indices)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(indices)
        ctx.dim, ctx.shape = dim, x.shape
        return values, indices

    @staticmethod
    def backward(ctx, grad, _):
        indices, = ctx.saved_tensors
        if grad is not None:
            grad = grad.new_zeros(ctx.shape).scatter(ctx.dim, indices, grad)
        return grad, None, None, None, None


def _topk_args(input, k, dim=-1, largest=True, sorted=True):
    return input, k, dim, largest, sorted


class _TopkBackwardLikeInput(TorchFunctionMode):
    """While the step traces, ``topk`` of a DTensor that autograd follows
    takes :class:`_TopkGradientLikeInput`, so that both torch releases lay
    its gradient out alike (the dense MoE route's router); every other
    call is left as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.topk, torch.Tensor.topk) \
                and isinstance(args[0], DTensor) and args[0].requires_grad \
                and torch.is_grad_enabled():
            return torch.return_types.topk(
                _TopkGradientLikeInput.apply(*_topk_args(*args, **kwargs)))
        return func(*args, **kwargs)


def _argmax_layout(x, dim=None, keepdim=False):
    """``x.argmax(dim)`` on a DTensor. Where no mesh dim of more than one
    rank splits ``dim``, each rank's own (DTensor 2.11's handler gathers
    over mesh dims of one rank and fails); where one does (the logits'
    vocabulary), each rank's maximum and its index, gathered over that
    mesh dim, pick the first of the largest (DTensor moves the whole
    tensor to split it elsewhere). A partial sum (a batch-1 decode's
    logits, contracted along d split over the idle data axes) is reduced
    first, as GSPMD reduces it."""
    if not isinstance(x, DTensor) or dim is None:
        return NotImplemented
    x = _whole(x, [])
    d, mesh = dim % x.ndim, x.device_mesh
    split = [m for m, p in enumerate(x.placements)
             if mesh.size(m) > 1 and p.is_shard(d)]
    if len(split) > 1:
        return NotImplemented
    kept = [Replicate() if not p.is_shard() or p.dim == d else p
            for p in x.placements]              # the output's, keepdim
    local = x.detach().to_local()
    index = torch.ops.aten.argmax.default(local, d, True)
    if split:
        m = split[0]
        top = torch.ops.aten.amax.default(local, [d], True)
        index = index + mesh.get_coordinate()[m] * local.shape[d]
        each = list(x.shape)
        each[d] = mesh.size(m)

        def over_ranks(t):      # (..., one a rank of m, ...) on every rank
            return DTensor.from_local(
                t, mesh, [Shard(d) if i == m else p
                          for i, p in enumerate(kept)], run_check=False,
                shape=torch.Size(each), stride=contiguous_stride(each)
            ).redistribute(mesh, kept).to_local()

        top, index = over_ranks(top), over_ranks(index)
        index = torch.ops.aten.gather.default(
            index, d, torch.ops.aten.argmax.default(top, d, True))
    shape = list(x.shape)
    shape[d] = 1
    placements = kept
    if not keepdim:
        index = index.squeeze(d)
        del shape[d]
        placements = [Shard(p.dim - (p.dim > d)) if p.is_shard() else p
                      for p in kept]
    shape = torch.Size(shape)
    return DTensor.from_local(index, mesh, placements, run_check=False,
                              shape=shape, stride=contiguous_stride(shape))


def _expand_over_batch(x, size, implicit=False):
    """A replicated scalar expanded to ``size`` (the backward of the loss's
    mean) on a DTensor: split over the data axes along dim 0, the batch,
    as GSPMD carries the batch's sharding into the backward pass (DTensor
    replicates it, and every gradient computed from it, down to the
    (B, S, V) logits, whole on every rank)."""
    ctx = get_parallel_context()
    if ctx is None or not ctx.constrain_activations \
            or not isinstance(x, DTensor) or x.device_mesh != ctx.mesh \
            or x.numel() != 1 or not size or size[0] % ctx.dp_size \
            or not all(p.is_replicate() for p in x.placements):
        return NotImplemented
    mesh = x.device_mesh
    placements = param_placements(P(ctx.data_spec), mesh)
    local = list(size)
    local[0] //= ctx.dp_size
    out = x.to_local().expand(local)
    size = torch.Size(size)
    return DTensor.from_local(out, mesh, placements, run_check=False,
                              shape=size, stride=out.stride())


def _split_logsumexp(x, dim, keepdim=False):
    """``x.logsumexp(dim)`` along a dim that mesh dims split (the logits'
    vocabulary) on a DTensor: each rank's max and sum of exponentials,
    reduced over those mesh dims (two all-reduces of (B, S) values), where
    DTensor gathers the whole dim (the (B, S, V) float32 logits)."""
    if not isinstance(x, DTensor) or len(dim) != 1:
        return NotImplemented
    d, mesh = dim[0] % x.ndim, x.device_mesh
    if not any(mesh.size(m) > 1 and p.is_shard() and p.dim == d
               for m, p in enumerate(x.placements)) \
            or any(p.is_partial() for p in x.placements):
        return NotImplemented
    # the max and the sum are partial over the split: each all-reduced
    # before the next step (torch 2.13's ``log`` would reduce-scatter the
    # sum and gather the logarithm)
    top = _whole(torch.amax(x, d, keepdim=True), [])
    out = torch.log(_whole(torch.sum(torch.exp(x - top), d, keepdim=True),
                           [])) + top
    return out if keepdim else out.squeeze(d)


def _partials_reduced(func):
    """``func`` (not linear in each operand: ``where``, an activation's
    backward) on DTensors with each partial sum among its operands reduced
    whole first, as GSPMD reduces a partial sum before a step that is not
    linear. DTensor's own rule differs by release: a one-sequence decode's
    logits, from a query contracted along d split over the idle data axes,
    into the mask's ``where`` (torch 2.13 scatters them onto another dim
    of the logits on the (2, 16, 16) mesh); the dense MoE route's experts'
    gradient, a partial sum over the data axis, into ``silu_backward``
    (2.13 scatters it along the experts' dim and gathers the result
    later). Torch 2.11 reduces both whole."""
    def layout(*args, **kwargs):
        if not any(isinstance(a, DTensor) and any(p.is_partial()
                                                  for p in a.placements)
                   for a in args):
            return NotImplemented
        # detached, as in _gather_weight (DTensor 2.11 has no detach_ rule)
        return func(*(_whole(a.detach(), []) if isinstance(a, DTensor)
                      else a for a in args), **kwargs)
    return layout


def _split_softmax(x, dim, half_to_float=False):
    """``x.softmax(dim)`` along a dim that mesh dims split (a decode
    step's logits over a cache split along its slots) on a DTensor: each
    rank's max and sum of exponentials reduced over those mesh dims, the
    probabilities left split, as GSPMD reduces them; DTensor gathers the
    whole dim."""
    if not isinstance(x, DTensor) or half_to_float:
        return NotImplemented
    d = dim % x.ndim
    if not _split_dims(x, d) or any(p.is_partial() for p in x.placements):
        return NotImplemented
    # the max and the sum are partial over the split: reduced, not moved
    e = torch.exp(x - _whole(torch.amax(x, d, keepdim=True), []))
    return e / _whole(torch.sum(e, d, keepdim=True), [])


def _whole(t, dims=None):
    """``t`` with every partial sum reduced and, over each mesh dim that
    splits one of ``dims`` (every dim when ``None``), gathered."""
    keep = [p.is_shard() and dims is not None and p.dim % t.ndim not in dims
            for p in t.placements]
    want = [p if k or p.is_replicate() else Replicate()
            for p, k in zip(t.placements, keep)]
    return t if want == list(t.placements) \
        else t.redistribute(t.device_mesh, want)


def _dtensor(local, like, placements, shape):
    shape = torch.Size(shape)
    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _searchsorted_layout(seq, x, *, out_int32=False, right=False,
                         side=None, sorter=None):
    """``torch.searchsorted(seq, x)`` of a 1-D ``seq`` on DTensors: ``seq``
    gathered whole, ``x``'s splits kept (each rank searches its values)."""
    if not isinstance(seq, DTensor) or not isinstance(x, DTensor) \
            or seq.ndim != 1 or sorter is not None:
        return NotImplemented
    seq, x = _whole(seq.detach()), _whole(x.detach(), [])
    local = torch.ops.aten.searchsorted.Tensor(
        seq.to_local(), x.to_local(), out_int32=out_int32, right=right,
        side=side)
    return _dtensor(local, x, x.placements, x.shape)


def _index_copy_layout(dest, dim, index, source):
    """``dest.index_copy_(dim, index, source)`` on DTensors, in place: the
    indices gathered whole, ``source`` laid out as ``dest`` with ``dim``
    whole, the copy made there and each rank's share of it written back
    into ``dest`` (with ``dim`` unsplit, each rank copies into its own
    share)."""
    if not all(isinstance(t, DTensor) for t in (dest, index, source)) \
            or any(p.is_partial() for p in dest.placements):
        return NotImplemented
    d, mesh = dim % dest.ndim, dest.device_mesh
    index = _whole(index)
    whole = _whole(dest.detach(), [d])
    source = source.detach().redistribute(mesh, whole.placements)
    split = whole.placements != dest.placements
    local = whole.to_local() if split else dest.to_local()
    torch.ops.aten.index_copy_.default(local, d, index.to_local(),
                                       source.to_local())
    if split:           # this rank's share of the copy, into dest's own
        dest.to_local().copy_(whole.redistribute(mesh, dest.placements)
                              .to_local())
    return dest


def _index_add_layout(dest, dim, index, source, alpha=1):
    """``dest.index_add(dim, index, source)`` on DTensors (the backward of
    ``index_select``: the gathered rows' gradients added back): ``dest``
    whole along ``dim``; where a mesh dim splits ``source``'s rows each rank
    adds its own rows (its block of ``index``), a partial sum over that
    mesh dim; elsewhere ``source`` is laid out as ``dest``. torch 2.11's
    rule meets the whole indices with the split rows."""
    if not all(isinstance(t, DTensor) for t in (dest, index, source)) \
            or index.ndim != 1:
        return NotImplemented
    d, mesh = dim % dest.ndim, dest.device_mesh
    base = _whole(dest.detach(), [d])
    rows = [m for m, p in enumerate(source.placements) if p.is_shard(d)]
    src = source.detach().redistribute(mesh, [
        p if m in rows else base.placements[m]
        for m, p in enumerate(source.placements)])
    ids = _whole(index).to_local()
    n = src.to_local().shape[d]
    ids = ids.narrow(0, _offset(src, d), n) if rows else ids
    local = base.to_local()
    coord = mesh.get_coordinate()
    if any(coord[m] for m in rows):     # dest counted once in the sum
        local = torch.zeros_like(local)
    local = torch.ops.aten.index_add.default(local, d, ids, src.to_local(),
                                             alpha=alpha)
    return _dtensor(local, dest, [Partial() if m in rows else p
                                  for m, p in enumerate(base.placements)],
                    dest.shape)


def _index_fill_layout(x, dim, index, value):
    """``x.index_fill(dim, index, value)`` on DTensors (the backward of
    ``index_copy_``, which zeroes the copied rows' gradient; torch 2.11 has
    no rule for it): each rank fills the indexed entries of its own share
    along ``dim``, the indices whole."""
    if not isinstance(x, DTensor) or not isinstance(index, DTensor) \
            or (value != 0 and any(p.is_partial() for p in x.placements)):
        return NotImplemented
    d = dim % x.ndim
    x = x.detach()
    ids = _whole(index).to_local()
    local = x.to_local()
    n = local.shape[d]
    ids = ids - _offset(x, d)
    keep = (ids >= 0) & (ids < n)
    # the rows of this share the indices name, found without a host sync
    hit = torch.zeros(n, dtype=torch.float32, device=local.device)
    hit = torch.ops.aten.index_add.default(
        hit, 0, torch.clamp(ids, 0, n - 1), keep.to(torch.float32)) > 0
    shape = [1] * local.ndim
    shape[d] = n
    local = torch.ops.aten.masked_fill.Scalar(local, hit.view(shape), value)
    return _dtensor(local, x, x.placements, x.shape)


def _scatter_add_layout(dest, dim, index, src):
    """``dest.scatter_add_(dim, index, src)`` on DTensors, in place, where
    ``dest`` is whole and ``index`` and ``src`` are split alike along
    ``dim`` (the router's expert loads, a count a slot): each rank adds its
    slots into zeros, the sum over the splitting mesh dims is reduced and
    added to ``dest``."""
    d = dim % dest.ndim
    if not all(isinstance(t, DTensor) for t in (dest, index, src)) \
            or index.placements != src.placements \
            or not all(p.is_replicate() for p in dest.placements) \
            or any(p.is_shard() and p.dim != d or p.is_partial()
                   for p in index.placements):
        return NotImplemented
    base = dest.to_local()
    part = torch.ops.aten.scatter_add.default(
        torch.zeros_like(base), d, index.to_local(), src.detach().to_local())
    part = DTensor.from_local(
        part, dest.device_mesh, [Partial() if p.is_shard() else Replicate()
                                 for p in index.placements],
        run_check=False, shape=dest.shape, stride=dest.stride()
    ).redistribute(dest.device_mesh, dest.placements).to_local()
    base.add_(part)
    return dest


def _split_dims(x, d: int) -> List[int]:
    """The mesh dims of more than one rank that split ``x`` along ``d``."""
    mesh = x.device_mesh
    return [m for m, p in enumerate(x.placements)
            if p.is_shard(d) and mesh.size(m) > 1]


def _pieces_split(x, sizes, d: int, mdims: List[int]):
    """``x``'s pieces of ``sizes`` along ``d`` (every placement but over
    ``mdims`` kept): each piece whose size ``mdims`` divide split along
    ``d`` over them, the others whole there. ``x`` is gathered over
    ``mdims`` first."""
    mesh = x.device_mesh
    ways = _world(tuple(mesh.size(m) for m in mdims))
    whole = x.redistribute(mesh, [Replicate() if m in mdims else p
                                  for m, p in enumerate(x.placements)])
    split = [Shard(d) if m in mdims else p
             for m, p in enumerate(whole.placements)]
    local, out, lo = whole.to_local(), [], 0
    coord = mesh.get_coordinate()
    block = 0               # this rank's block over mdims, outermost first
    for m in mdims:
        block = block * mesh.size(m) + coord[m]
    for n in sizes:
        piece = local.narrow(d, lo, n)
        lo += n
        shape = list(x.shape)
        shape[d] = n
        if n % ways:
            out.append(_dtensor(piece, x, whole.placements, shape))
            continue
        piece = piece.narrow(d, block * (n // ways), n // ways)
        out.append(_dtensor(piece, x, split, shape))
    return out


def _split_keeping(x, split_sizes, dim=0):
    """``torch.split(x, sizes, dim)`` along a dim that mesh dims split (the
    column-split projection's (z, x, B, C, dt) in Mamba-2) on a DTensor:
    each piece whose size the splitting ranks divide stays split along
    ``dim`` as GSPMD keeps a slice of a split dim split, the others are
    whole; DTensor gathers every piece whole. ``NotImplemented`` where no
    mesh dim splits ``dim``."""
    if not isinstance(x, DTensor) or any(p.is_partial()
                                         for p in x.placements):
        return NotImplemented
    d = dim % x.ndim
    mdims = _split_dims(x, d)
    if not mdims:
        return NotImplemented
    return tuple(_pieces_split(x.detach(), split_sizes, d, mdims))


def _reduce_partials(func):
    """``func`` (a pointwise op) on DTensors with each partial sum over the
    model axis that meets an operand that is not one reduced whole first
    (all-reduce), as Megatron reduces a row-parallel product's output; DTensor
    scatters it over the batch instead (a reduce-scatter), and the batch split
    over the model axis then meets every activation the model axis splits
    along its features, each meeting a gather. A partial sum over another
    mesh dim (a data axis) that meets an operand that is not one is reduced
    first where it holds fewer elements than the result (the dense MoE
    route's routing weights, (S k, 1), against the experts' (S k, d)
    output), as torch 2.11 and GSPMD reduce it; torch 2.13 keeps a product's
    partial sum and reduces the result. A division of a partial sum over a
    data axis by an operand that mesh dim splits (in the router's backward,
    the normalised routing weights' gradient by the denominators, split as
    the tokens) reduce-scatters the partial sum onto that split first
    (:func:`_split_like`), as torch 2.11 does and as GSPMD reduces it
    before the division; 2.13 gathers the denominators and divides the
    whole partial sum, which it scatters later. Under sequence parallelism
    DTensor's rule stands: it scatters the partial sum onto the sequence
    split, as Megatron's sequence parallelism does."""
    def layout(*args, **kwargs):
        ctx = get_parallel_context()
        dts = [a for a in args if isinstance(a, DTensor)]
        if ctx is None or ctx.sequence_parallel or len(dts) < 1:
            return NotImplemented
        mesh = dts[0].device_mesh
        names = mesh.mesh_dim_names or ()
        model = names.index(ctx.model_axis) if ctx.model_axis in names \
            else None
        # {id: {mesh dim: placement}}: Replicate() to reduce whole, a
        # Shard to reduce onto
        to = {id(a): {} for a in dts}
        if model is not None and mesh.size(model) > 1:
            for i in _model_gathers(dts, model):
                to[i][model] = Replicate()
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        out = torch.broadcast_shapes(*(a.shape for a in tensors))
        for m in range(mesh.ndim):
            part = [a for a in dts if a.placements[m].is_partial()]
            if m == model or mesh.size(m) == 1 or not part \
                    or len(part) == len(tensors):
                continue
            for a in part:
                if a.numel() < out.numel():
                    to[id(a)][m] = Replicate()
                elif func is torch.ops.aten.div.Tensor:
                    onto = _split_like(a, dts, m)
                    if onto is not None:
                        to[id(a)][m] = onto
        if not any(to.values()):
            return NotImplemented
        # detached, as in _gather_weight (DTensor 2.11 has no detach_ rule)
        args = [a.detach().redistribute(mesh, [
            to[id(a)].get(i, p) for i, p in enumerate(a.placements)])
                if isinstance(a, DTensor) and to[id(a)] else a
                for a in args]
        return func(*args, **kwargs)
    return layout


def _split_like(a, dts, m: int) -> Optional[Shard]:
    """The split of ``a`` (a partial sum over mesh dim ``m``) along the dim
    that another operand of ``dts`` holds split over ``m`` at ``a``'s
    extent (the dims aligned from the right, as they broadcast): the
    placement a reduce-scatter of ``a`` onto that operand's split leaves;
    ``None`` where no operand is so split."""
    for b in dts:
        p = b.placements[m]
        if b is a or not p.is_shard():
            continue
        d = p.dim - b.ndim + a.ndim
        if d >= 0 and b.shape[p.dim] == a.shape[d] > 1:
            return Shard(d)
    return None


def _model_gathers(dts, m) -> set:
    """The ids of the operands a pointwise op gathers over the model axis
    (mesh dim ``m``): each partial sum there that meets an operand that is
    not one, or of operands split along different (broadcast) dims, the
    smaller."""
    part = [a.placements[m].is_partial() for a in dts]
    if any(part) and not (all(part) and len(dts) > 1):
        return {id(a) for a, q in zip(dts, part) if q}
    split = {(a.placements[m].dim - a.ndim) for a in dts
             if a.placements[m].is_shard() and a.shape[
                 a.placements[m].dim] > 1}
    if len(split) < 2:
        return set()
    return {id(min((a for a in dts if a.placements[m].is_shard()),
                   key=lambda a: a.numel()))}


# operations DTensor's own rules (torch 2.11) lay out otherwise than GSPMD
# (the weight of a product, gather's backward, the loss's gradient, the
# logits' logsumexp and argmax) or fail on (argmax along an unsplit dim:
# its handler gathers over mesh dims of one rank; the embedding's lookup
# with its indices split over two mesh dims, and its backward, whose rule
# builds an unnormalized Shard(-1)); the MoE and Mamba-2 layers' (the
# dense route's search, copies and load count; a decode's projection
# split, the partial sums and conflicting splits of pointwise ops); each
# rule returns NotImplemented where it does not apply, and DTensor's own
# rule runs
_LAYOUTS = {torch.ops.aten.mm.default: _gather_weight,
            torch.ops.aten.bmm.default: _gather_weight,
            torch.ops.aten.index.Tensor: _embedding_lookup,
            torch.ops.aten.index_put.default: _embedding_grad,
            torch.ops.aten.new_zeros.default: _zeros_like_source,
            torch.ops.aten.scatter_add.default: _scatter_into_split,
            torch.ops.aten.scatter.src: _scatter_by_rows,
            torch.ops.aten.expand.default: _expand_over_batch,
            torch.ops.aten.logsumexp.default: _split_logsumexp,
            torch.ops.aten._softmax.default: _split_softmax,
            torch.ops.aten.argmax.default: _argmax_layout,
            torch.ops.aten.searchsorted.Tensor: _searchsorted_layout,
            torch.ops.aten.index_copy_.default: _index_copy_layout,
            torch.ops.aten.scatter_add_.default: _scatter_add_layout,
            torch.ops.aten.split_with_sizes.default: _split_keeping,
            torch.ops.aten.index_add.default: _index_add_layout,
            torch.ops.aten.index_fill.int_Scalar: _index_fill_layout}
_LAYOUTS.update({op: _reduce_partials(op) for op in (
    torch.ops.aten.add.Tensor, torch.ops.aten.sub.Tensor,
    torch.ops.aten.mul.Tensor, torch.ops.aten.div.Tensor,
    torch.ops.aten.pow.Tensor_Scalar)})
_LAYOUTS.update({op: _partials_reduced(op) for op in (
    torch.ops.aten.where.self, torch.ops.aten.silu_backward.default,
    torch.ops.aten.gelu_backward.default)})
_LAYOUTS.update({op: _flatten_gathered(op) for op in (
    torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
    torch.ops.aten.reshape.default)})


def _fake_mode_of(tensors: List[torch.Tensor]):
    for t in tensors:
        mode = getattr(_local(t), "fake_mode", None)
        if mode is not None:
            return mode
    raise ValueError("the dry run's inputs must be fake tensors "
                     "(build_dryrun's)")


def account(fn, args: Tuple) -> Dict[str, Any]:
    """Run ``fn(*args)`` over its fake inputs and count rank 0's work:
    ``flops``, ``bytes_accessed``, ``collective_bytes`` /
    ``collective_counts`` / ``collective_link_bytes`` / ``reduce_ops``,
    ``attention`` (each flash call's layout), ``attention_flops`` (the
    flash calls' FLOPs, ``kernel``, beside ``all_pairs``: the same calls
    counted over every (query, key) pair, 4 S_q S_k D a forward and 8 a
    backward, as the reference's ``chunked_attention`` issues them),
    ``attention_bytes`` (of ``bytes_accessed``, the flash calls'),
    ``memory`` (argument, output, temp and total bytes) and
    ``trace_s``."""
    check_torch()
    tensors = _leaves(args)
    acct = Accountant(_fake_mode_of(tensors), tensors)
    with implicit_replication(), _views_reshard(), _alltoall_as_on_cuda(), \
            _unpad_as_a_view(), _shape_inference_uncounted(acct), \
            _TopkBackwardLikeInput(), acct:
        held = {}       # each storage once, however many leaves share it
        for t in tensors:
            key = _storage_key(_local(t))
            if key not in held:
                held[key] = acct.track(_local(t))
        t0 = time.perf_counter()
        out = fn(*args)
        trace_s = time.perf_counter() - t0
        new = {}
        for t in _leaves(out):
            key = _storage_key(_local(t))
            if key not in held:
                new[key] = _local(t).untyped_storage().nbytes()
        del out
    # as jax.jit drops the arguments a step never reads (its default
    # keep_unused=False: a decode step's encoder and cross-attention K/V
    # weights), they count neither as arguments nor at the peak
    unused = sum(n for k, n in held.items() if k not in acct.read)
    arg_bytes = sum(held.values()) - unused
    live = acct.live_at_peak()
    return {
        "flops": acct.flops, "bytes_accessed": acct.bytes,
        "collective_link_bytes": acct.link_bytes(),
        "collective_bytes": dict(acct.coll_bytes),
        "collective_counts": dict(acct.coll_counts),
        "reduce_ops": dict(acct.reduce_ops),
        "unknown_collectives": dict(acct.unknown),
        "attention": {k: dict(v) for k, v in acct.attention.items() if v},
        "attention_flops": dict(acct.attention_flops),
        "attention_bytes": acct.attention_bytes,
        "at_peak": [dict(bytes=n, op=op, shape=list(shape), dtype=dt)
                    for n, op, shape, dt in heapq.nlargest(PEAK_LARGEST,
                                                           live)],
        "live_at_peak": live,
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": sum(new.values()),
                   "temp_bytes": acct.peak - unused - arg_bytes,
                   "total_bytes": acct.peak - unused},
        "trace_s": trace_s,
    }


# -------------------------------------------------------------------- rows
def run_one(arch: str, shape_name: str, multi_pod: bool,
            grad_sync: str = "auto", out_dir: str = "experiments/dryrun_torch",
            seq_parallel: bool = False, microbatches: int = 1, tag: str = "",
            moe_impl: str = "", device: str = "cuda") -> Dict[str, Any]:
    """One row: trace the step on the production mesh under a fake process
    group and write the row as JSON to ``out_dir``."""
    shape, _ = PRODUCTION_SHAPES[multi_pod]
    with fake_process_group(_world(shape)):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        dp_axes, model_axis = mesh_axes(mesh)
        ctx = ParallelContext(mesh=mesh, data_axes=dp_axes,
                              model_axis=model_axis,
                              sequence_parallel=seq_parallel)
        t0 = time.perf_counter()
        with parallel_context(ctx):
            fn, args, cfg = build_dryrun(arch, shape_name, mesh,
                                         grad_sync=grad_sync,
                                         microbatches=microbatches,
                                         moe_impl=moe_impl, device=device)
            acc = account(fn, args)
            del fn, args
        t_trace = time.perf_counter() - t0
        chips = mesh.size()
    spec = INPUT_SHAPES[shape_name]
    flops_dev = acc["flops"]
    mf = model_flops_per_step(cfg, spec["kind"], spec["seq_len"],
                              spec["global_batch"])
    terms = {"compute_s": flops_dev / PEAK_FLOPS_BF16,
             "memory_s": acc["bytes_accessed"] / HBM_BW,
             "collective_s": acc["collective_link_bytes"] / LINK_BW}
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": int(chips), "grad_sync": grad_sync,
        "seq_parallel": seq_parallel, "microbatches": microbatches,
        "compile_s": t_trace, "device": device,
        "model_variant": cfg.name,
        "per_device": {k: acc[k] for k in (
            "flops", "bytes_accessed", "collective_link_bytes",
            "collective_bytes", "collective_counts", "reduce_ops",
            "unknown_collectives")},
        "attention": acc["attention"],
        "memory": acc["memory"],
        "at_peak": acc["at_peak"],
        "roofline": {
            **terms,
            "dominant": max(terms, key=terms.get),
            "model_flops_global": mf,
            "model_flops_per_device": mf / chips,
            "useful_flops_ratio": (mf / chips) / flops_dev
            if flops_dev else 0.0,
        },
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{grad_sync}" if grad_sync != "auto" else ""
    if tag:
        suffix += f"__{tag}"
    fname = f"{arch.replace('/', '_')}__{shape_name}__" \
            f"{result['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(result, f, indent=1)
    return result


def should_skip(arch: str, shape_name: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.supports_long_decode():
        return "enc-dec full attention — documented skip (DESIGN.md §5)"
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    choices=["all"] + list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--grad-sync", default="auto")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--moe-impl", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (no memory is taken)")
    args = ap.parse_args(argv)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            skip = should_skip(arch, shape)
            if skip:
                print(f"SKIP  {arch:18s} {shape:12s}: {skip}", flush=True)
                continue
            for mp in meshes:
                tag = f"{arch:18s} {shape:12s} {'2x16x16' if mp else '16x16 '}"
                try:
                    r = run_one(arch, shape, mp, grad_sync=args.grad_sync,
                                out_dir=args.out,
                                seq_parallel=args.seq_parallel,
                                microbatches=args.microbatches, tag=args.tag,
                                moe_impl=args.moe_impl, device=args.device)
                    roof = r["roofline"]
                    print(f"OK    {tag} compile={r['compile_s']:6.1f}s "
                          f"mem/dev={r['memory']['total_bytes']/2**30:6.2f}GiB "
                          f"dom={roof['dominant']:12s} "
                          f"useful={roof['useful_flops_ratio']:.2f}",
                          flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"FAIL  {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nall dry-runs traced.")


if __name__ == "__main__":
    main()
