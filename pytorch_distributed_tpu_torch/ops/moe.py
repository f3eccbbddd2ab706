"""Mixture-of-Experts MLP (top-1 Switch / top-k GShard) in plain PyTorch.

The port of the JAX package's ``ops/moe.py`` (``expert_capacity``,
``_route``, ``_expert_compute``, ``_assignment_positions``,
``_dispatch_einsum``, ``_dispatch_sort``, ``moe_mlp``). It is no Pallas
kernel there, so plain tensor code is the port.

Routing: an f32 router product and softmax; ``top_k=1`` sends each token
to its argmax expert, gated by that expert's raw probability (Switch);
``top_k>1`` to its k most probable experts, the selected probabilities
renormalised to sum to 1 (GShard). Ties go to the lower expert id, as
``jax.lax.top_k`` and ``argmax`` break them: the top k come from a stable
descending ``argsort``, because ``torch.topk`` gives no order for ties.

Capacity: C = ceil(A * factor / X) slots per expert for the A = T * k
assignments; an assignment past its expert's C slots is dropped (its MLP
contribution is exactly 0). Priority is assignment order (token, then
choice rank): a stable sort of the expert ids.

Dispatch (``dispatch_impl``), the same results by two routes:

- ``"einsum"``: the f32 [A, X, C] one-hot dispatch tensor and a pair of
  products, as Switch/Mesh-TensorFlow write it.
- ``"sort"``: no [A, X, C] tensor. Each expert slot gathers the assignment
  that fills it (the stable sort's segment arithmetic), so only kept
  slots are written, and each assignment gathers its slot's output back.
- ``"auto"``: einsum while the dispatch tensor has at most
  ``_AUTO_EINSUM_LIMIT`` elements, else sort.

Determinism on the card. The JAX combine is a scatter-add over tokens
(``.at[tok].add``); on CUDA that would be atomic, and with ``top_k >= 2``
the order of a token's sum would change from run to run. Here each
assignment's weighted output lands in assignment order and a token's k
contributions are summed by ``.view(T, K, D).sum(1)``, in a fixed order;
the gradient of the token vectors likewise sums over k through an
``expand``, and the sort path moves rows only by gathers whose gradients
are gathers through the inverse map (``_Rows``: dropped entries read a
zero pad row), so nothing accumulates by atomics or index sorting. Two
runs of a step give the same bits.

Under ``ops/remat`` the products go through ``remat.product``: ``dots``
keeps the router product, the einsum dispatch product and the expert
products; ``dots_no_batch`` the first two (the expert products batch over
the experts); ``names`` nothing (the MoE MLP has no tag), as JAX's
``saved_residuals`` show (tests/test_torch_moe.py).

The aux loss is Switch's load-balancing term over first choices,
X * sum_e(fraction_e * mean_prob_e). Tensor parallelism inside each expert
(``tensor_axis``, the tensor process group: ``w_in``/``w_gate`` column-
and ``w_out`` row-parallel on F, one all-reduce after ``w_out``) serves
TP decode and TP training (its backward through ``ops/tp``: ``tp_copy``
on the expert batches, so the router and the dispatch, which run on
replicated activations, get whole gradients on every rank).

Expert parallelism (``expert_axis``, the expert process group of n ranks,
JAX's ``_expert_compute``): each rank holds X/n experts' weights (``w_in``
[X/n, D, F] ..., ``parallel/sharding``) and its own tokens; the router is
whole on every rank, so each rank routes its tokens over all X experts and
fills its [X, C, D] slots as on one device. One all-to-all (split 0,
concat 1, ``ops/all_to_all``) sends each expert's slots to its owner:
[X, C, D] -> [X/n, n C, D], rank i's slots at place i; the owner runs its
experts on every rank's slots, and the reverse exchange (split 1, concat
0) brings each rank its slots' outputs back. Capacity and the aux term
are per token shard: C counts this rank's tokens, and the aux term is
this rank's (the training step averages it over the ranks, as JAX does).
The backward of each exchange is the reverse exchange, so an expert's
weight gradient sums every rank's tokens routed to it. It composes with
``tensor_axis`` (TP inside each local expert, after the dispatch
exchange). ``all_to_alls`` counts the exchanges this module issues: 2 a
MoE layer in the forward and 2 in the backward, and 2 more in the
recompute of a checkpointed block (``exchanges_per_layer``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.ops.all_to_all import all_to_all
from pytorch_distributed_tpu_torch.ops.remat import product
from pytorch_distributed_tpu_torch.ops.tp import tp_copy, tp_reduce

# "auto" switches einsum -> sort once the [A, X, C] dispatch tensor would
# exceed this many elements (64 MiB of f32), as in the JAX package.
_AUTO_EINSUM_LIMIT = 16 * 1024 * 1024

all_to_alls = 0  # expert exchanges issued by this module


def _count() -> None:
    global all_to_alls
    all_to_alls += 1


def exchanges_per_layer(remat_mode: str) -> int:
    """Expert all-to-alls a MoE layer issues for one micro-batch's forward
    and backward under ``expert_axis``: the dispatch and return exchanges
    in the forward and their reverses in the backward, and under every
    checkpointing mode both again in the block's recompute (no mode keeps
    an exchange's result: the expert products' backward needs the
    exchanged slots, and the combine the returned outputs)."""
    return 4 if remat_mode == "none" else 6


def expert_capacity(tokens: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Per-expert token slots: ceil(tokens / experts * factor), min 1."""
    return max(1, int(tokens * capacity_factor / n_experts + 0.999999))


def _route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """(expert_idx [T, K] int64, gates [T, K] f32, probs [T, X] f32)."""
    logits = product(xt.float(), router.float())  # [T, X]
    probs = torch.softmax(logits, dim=-1)
    if top_k == 1:
        idx = probs.argmax(dim=-1, keepdim=True)  # first maximum, as JAX
        return idx, probs.gather(-1, idx), probs
    idx = torch.argsort(probs, dim=-1, descending=True,
                        stable=True)[:, :top_k]
    gates = probs.gather(-1, idx)
    return idx, gates / gates.sum(dim=-1, keepdim=True), probs


def _expert_compute(expert_in: torch.Tensor, params: dict,
                    activation: Callable, expert_axis=None,
                    tensor_axis=None) -> torch.Tensor:
    """[X, C, D] expert batches -> [X, C, D]. Dense experts:
    act(x @ w_in) @ w_out; gated (SwiGLU) experts with ``w_gate``:
    (act(x @ w_gate) * (x @ w_in)) @ w_out; weights cast to the batches'
    dtype. ``expert_axis`` (the expert process group): the weights are
    this rank's X/n experts, and the all-to-all pair (module docstring)
    moves the slots to their owners and back. ``tensor_axis`` (the tensor
    process group): Megatron TP inside each expert — ``w_in``/``w_gate``
    hold this rank's columns of F, ``w_out`` its rows, and one all-reduce
    after ``w_out`` restores the full output (the f/g pair of
    ``ops/tp``)."""
    dt = expert_in.dtype
    if expert_axis is not None:  # [X, C, D] -> [X/n, n C, D]
        expert_in = all_to_all(expert_in, expert_axis, 0, 1, _count)
    expert_in = tp_copy(expert_in, tensor_axis)
    h = product(expert_in, params["w_in"].to(dt))
    if "w_gate" in params:
        h = activation(product(expert_in, params["w_gate"].to(dt))) * h
    else:
        h = activation(h)
    out = tp_reduce(product(h, params["w_out"].to(dt)), tensor_axis)
    if expert_axis is not None:  # back to [X, C, D]
        out = all_to_all(out, expert_axis, 1, 0, _count)
    return out


def _assignment_positions(e_flat: torch.Tensor, n_experts: int):
    """Position of each assignment in its expert's queue (0-based, in
    assignment order), by a stable sort of the expert ids. Returns (pos,
    order, e_sorted, pos_sorted, starts, counts): ``order`` sorts the
    assignments by expert, ``starts``/``counts`` are each expert's segment
    of the sorted list. No host sync: the segments come from
    ``searchsorted`` on the sorted ids (``bincount`` on CUDA reads the
    largest id on the host)."""
    a = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    experts = torch.arange(n_experts, device=e_flat.device,
                           dtype=e_sorted.dtype)
    starts = torch.searchsorted(e_sorted, experts)
    counts = torch.searchsorted(e_sorted, experts, right=True) - starts
    pos_sorted = torch.arange(a, device=e_flat.device) - starts[e_sorted]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return pos, order, e_sorted, pos_sorted, starts, counts


class _Rows(torch.autograd.Function):
    """``cat([x, 0])[index]``: rows of ``x`` [N, D] by ``index`` [M] (N
    reads the zero pad row), where no row of ``x`` is read twice; the
    gradient is the same gather through the inverse map ``inverse`` [N]
    (the output row that read each row of x, M if none), so neither
    direction accumulates (an indexing backward would scatter-add, and
    sort the indices to do it)."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(inverse)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[index]

    @staticmethod
    def backward(ctx, g):
        inverse, = ctx.saved_tensors
        return torch.cat([g, g.new_zeros(1, g.shape[1])])[inverse], None, None


def _combine(expert_out: torch.Tensor, slot: torch.Tensor,
             src: torch.Tensor, gate_flat: torch.Tensor, t: int,
             k: int) -> torch.Tensor:
    """Each assignment's slot output (``slot``: X * C for a dropped one,
    which reads a zero row; ``src``: the assignment each slot serves, A if
    none) times its gate, summed per token over its k choices in rank
    order: [T, D] f32."""
    x, c, d = expert_out.shape
    vals = _Rows.apply(expert_out.reshape(x * c, d).float(), slot, src)
    return (vals * gate_flat[:, None]).view(t, k, d).sum(1)


def _dispatch_einsum(xt, expert_idx, gates, n_experts, cap, params,
                     activation, out_dtype, expert_axis=None,
                     tensor_axis=None):
    """One-hot dispatch through the f32 [A, X, C] tensor."""
    t, k = expert_idx.shape
    a = t * k
    dev = xt.device
    e_flat = expert_idx.reshape(a)
    pos = _assignment_positions(e_flat, n_experts)[0]
    keep = (pos < cap).float()
    # Rows past the last slot are all-zero one-hots, as jax.nn.one_hot
    # gives for an out-of-range index (F.one_hot would raise).
    onehot_e = (e_flat[:, None] == torch.arange(n_experts, device=dev)
                ).float()
    onehot_c = (pos[:, None] == torch.arange(cap, device=dev)).float()
    dispatch_a = (onehot_e * keep[:, None])[:, :, None] * onehot_c[:, None, :]
    dispatch = dispatch_a.view(t, k, n_experts, cap).sum(1)
    combine = (dispatch_a * gates.reshape(a)[:, None, None]
               ).view(t, k, n_experts, cap).sum(1)
    expert_in = product(dispatch.view(t, n_experts * cap).t(),
                        xt.float()).view(n_experts, cap, -1).to(out_dtype)
    expert_out = _expert_compute(expert_in, params, activation, expert_axis,
                                 tensor_axis)
    return combine.view(t, n_experts * cap) @ \
        expert_out.float().view(n_experts * cap, -1)


def _dispatch_sort(xt, expert_idx, gates, n_experts, cap, params,
                   activation, out_dtype, expert_axis=None,
                   tensor_axis=None):
    """Segment dispatch: no [A, X, C] tensor, the same semantics."""
    t, k = expert_idx.shape
    a = t * k
    d = xt.shape[-1]
    dev = xt.device
    e_flat = expert_idx.reshape(a)
    pos, order, _, _, starts, counts = _assignment_positions(e_flat,
                                                             n_experts)
    # Slot (e, p) holds the p-th assignment of expert e's sorted segment,
    # if that exists and p < cap (so only kept assignments are written);
    # ``slot`` maps each assignment back (X * C: dropped).
    p = torch.arange(cap, device=dev)
    filled = p[None, :] < counts[:, None]  # [X, C]
    src = order[(starts[:, None] + p[None, :]).clamp_max(a - 1)]
    src = torch.where(filled, src, a).reshape(-1)
    keep = pos < cap
    slot = torch.where(keep, e_flat * cap + pos, n_experts * cap)
    # Each token's vector once per choice (the expand's gradient sums over
    # k in a fixed order).
    x_rep = xt.to(out_dtype)[:, None, :].expand(t, k, d).reshape(a, d)
    expert_in = _Rows.apply(x_rep, src, slot).view(n_experts, cap, d)
    expert_out = _expert_compute(expert_in, params, activation, expert_axis,
                                 tensor_axis)
    gate_flat = torch.where(keep, gates.reshape(a).float(), 0.0)
    return _combine(expert_out, slot, src, gate_flat, t, k)


def moe_mlp(x: torch.Tensor, params: dict, *, activation: Callable,
            capacity_factor: float = 1.25, expert_axis=None,
            tensor_axis=None, top_k: int = 1,
            dispatch_impl: str = "auto"):
    """[B, T, D] -> (output [B, T, D] in x's dtype, aux f32 scalar).
    ``params``: router [D, X]; w_in [X, D, F]; w_out [X, F, D]; optional
    w_gate [X, D, F] (SwiGLU experts). ``expert_axis``: the expert process
    group of expert parallelism (module docstring; the expert weights are
    this rank's X/n experts, ``x`` this rank's tokens). ``tensor_axis``:
    the tensor process group for TP inside each expert (the expert weights
    this rank's F slice, ``parallel/sharding``); routing runs on the
    replicated activations, so every rank routes alike."""
    for name, group, axis in (("expert_axis", expert_axis, "expert"),
                              ("tensor_axis", tensor_axis, "tensor")):
        if isinstance(group, str):
            raise TypeError(
                f"{name} is the {axis} process group in the port "
                f"(parallel/mesh.Mesh.axis_group({axis!r})), got the axis "
                f"name {group!r}")
    b, t, d = x.shape
    n_tokens = b * t
    xt = x.reshape(n_tokens, d)
    n_experts = params["router"].shape[-1]
    if not 1 <= top_k <= n_experts:
        raise ValueError(f"top_k={top_k} out of range for {n_experts} experts")
    if expert_axis is not None:
        n = dist.get_world_size(expert_axis)
        if params["w_in"].shape[0] * n != n_experts:
            raise ValueError(
                f"an expert_axis of {n} ranks needs n_experts={n_experts} "
                f"split evenly over them; w_in holds "
                f"{params['w_in'].shape[0]} experts")
    expert_idx, gates, probs = _route(xt, params["router"], top_k)
    # Capacity scales with the assignment count (GShard), as in JAX.
    cap = expert_capacity(n_tokens * top_k, n_experts, capacity_factor)

    first = (expert_idx[:, :1] == torch.arange(n_experts, device=x.device)
             ).float()
    aux = n_experts * (first.mean(0) * probs.mean(0)).sum()

    if dispatch_impl == "auto":
        a = n_tokens * top_k
        dispatch_impl = ("einsum" if a * n_experts * cap <= _AUTO_EINSUM_LIMIT
                         else "sort")
    if dispatch_impl == "einsum":
        out = _dispatch_einsum(xt, expert_idx, gates, n_experts, cap, params,
                               activation, x.dtype, expert_axis, tensor_axis)
    elif dispatch_impl == "sort":
        out = _dispatch_sort(xt, expert_idx, gates, n_experts, cap, params,
                             activation, x.dtype, expert_axis, tensor_axis)
    else:
        raise ValueError(f"unknown dispatch_impl {dispatch_impl!r}")
    return out.to(x.dtype).reshape(b, t, d), aux


def dropped_share(x: torch.Tensor, router: torch.Tensor, *, top_k: int,
                  capacity_factor: float) -> torch.Tensor:
    """The share of the assignments of ``x`` [B, T, D] that ``moe_mlp``
    drops for capacity (a device scalar)."""
    xt = x.reshape(-1, x.shape[-1])
    n_experts = router.shape[-1]
    idx = _route(xt, router, top_k)[0]
    cap = expert_capacity(xt.shape[0] * top_k, n_experts, capacity_factor)
    pos = _assignment_positions(idx.reshape(-1), n_experts)[0]
    return (pos >= cap).float().mean()
