"""Weight import and export: HF GPT-2, Llama and Mixtral state dicts and
reference-style (torch ``nn.Linear``) GPT-2 state dicts.

The port of the JAX package's ``models/hf_import.py``, with the same
function names, layout tables and shape checks. It takes and returns the
port's params (``models/gpt2``, ``models/llama``: per-layer dicts of
tensors): the HF names map onto the JAX package's stacked [L, ...] tree
in numpy, exactly as there, and ``interop`` converts that tree to and
from the port's layout. ``transformers`` is imported only inside
``from_hf_pretrained``.

Layouts: HF GPT-2 stores c_attn/c_proj/c_fc as Conv1D weights [in, out],
the port's dense kernels' own layout, so they import without a transpose;
torch-Linear dicts ([out, in]: the reference model's ``save()``, HF
Llama's projections) are transposed. HF's flat [E, 3E] merged-QKV columns
are [q | k | v], each head-major: the port's [E, 3, H, D] kernel
flattened. Mixtral's experts compute w2(silu(w1 x) * w3 x), so w1 is the
port's ``w_gate``, w3 ``w_in`` and w2 ``w_out``.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig


def _to_np(x) -> np.ndarray:
    """A numpy copy of a state-dict value (a bf16 tensor as its f32
    values: numpy has no bfloat16 of its own)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _map_leaves(node, fn):
    if isinstance(node, dict):
        return {k: _map_leaves(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_leaves(v, fn) for v in node]
    return fn(node)


def _params(tree: dict, cfg: ModelConfig) -> dict:
    """The stacked numpy tree -> the port's params in ``cfg.param_dtype``."""
    dtype = getattr(torch, cfg.param_dtype)
    return _map_leaves(interop.params_from_jax(tree, cfg),
                       lambda t: t.to(dtype))


def _stacked(params: dict, family: str) -> dict:
    """The port's params -> the stacked numpy tree (bf16 leaves as f32)."""
    cfg = ModelConfig(family=family, n_layer=len(params["blocks"]))
    return interop.params_to_jax(_map_leaves(
        params, lambda t: t.float() if t.dtype == torch.bfloat16 else t), cfg)


# HF GPT-2 parameter names (relative prefix; both bare and "transformer."-
# prefixed checkpoints exist).
_HF_BLOCK_KEYS = {
    "ln_1.weight": ("ln_1", "scale"),
    "ln_1.bias": ("ln_1", "bias"),
    "attn.c_attn.weight": ("attn", "c_attn", "kernel"),
    "attn.c_attn.bias": ("attn", "c_attn", "bias"),
    "attn.c_proj.weight": ("attn", "c_proj", "kernel"),
    "attn.c_proj.bias": ("attn", "c_proj", "bias"),
    "ln_2.weight": ("ln_2", "scale"),
    "ln_2.bias": ("ln_2", "bias"),
    "mlp.c_fc.weight": ("mlp", "c_fc", "kernel"),
    "mlp.c_fc.bias": ("mlp", "c_fc", "bias"),
    "mlp.c_proj.weight": ("mlp", "c_proj", "kernel"),
    "mlp.c_proj.bias": ("mlp", "c_proj", "bias"),
}

# HF Conv1D [in, out] kernels: the port's layout, imported as they are.
_KERNELS = {
    "attn.c_attn.weight",
    "attn.c_proj.weight",
    "mlp.c_fc.weight",
    "mlp.c_proj.weight",
}


def _strip_prefix(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        out[k] = v
    return out


def _set_nested(tree: dict, path: tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def from_hf_gpt2_state_dict(sd: dict, cfg: ModelConfig) -> dict:
    """An HF GPT2LMHeadModel/GPT2Model state dict -> the port's gpt2
    params. Conv1D weights import without a transpose; ``lm_head.weight``
    is ignored (the head is tied to wte)."""
    return _import_state_dict(sd, cfg, kernels_transposed=False)


def from_reference_state_dict(sd: dict, cfg: ModelConfig) -> dict:
    """A torch-Linear-layout GPT-2 state dict (every linear weight [out,
    in], transposed here) -> the port's gpt2 params."""
    return _import_state_dict(sd, cfg, kernels_transposed=True)


def _import_state_dict(sd: dict, cfg: ModelConfig, *,
                       kernels_transposed: bool) -> dict:
    sd = _strip_prefix({k: _to_np(v) for k, v in sd.items()})

    def kernel_fix(name: str, arr: np.ndarray) -> np.ndarray:
        if name in _KERNELS and kernels_transposed:
            return arr.T
        return arr

    tree: dict = {
        "wte": sd["wte.weight"],
        "wpe": sd["wpe.weight"],
        "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
        "blocks": {},
    }
    if tree["wte"].shape != (cfg.vocab_size, cfg.n_embd):
        raise ValueError(
            f"wte shape {tree['wte'].shape} != "
            f"({cfg.vocab_size}, {cfg.n_embd})"
        )
    for hf_key, path in _HF_BLOCK_KEYS.items():
        per_layer = []
        for layer in range(cfg.n_layer):
            name = f"h.{layer}.{hf_key}"
            if name not in sd:
                raise KeyError(f"missing {name!r} in state dict")
            per_layer.append(kernel_fix(hf_key, sd[name]))
        _set_nested(tree["blocks"], path, np.stack(per_layer))

    expect_qkv = (cfg.n_layer, cfg.n_embd, 3 * cfg.n_embd)
    got = tree["blocks"]["attn"]["c_attn"]["kernel"].shape
    if got != expect_qkv:
        raise ValueError(
            f"c_attn kernel stacked shape {got} != {expect_qkv} — wrong "
            "layout? (use from_reference_state_dict for torch-Linear dicts)"
        )
    h, d = cfg.n_head, cfg.head_dim
    attn = tree["blocks"]["attn"]["c_attn"]
    attn["kernel"] = attn["kernel"].reshape(cfg.n_layer, cfg.n_embd, 3, h, d)
    attn["bias"] = attn["bias"].reshape(cfg.n_layer, 3, h, d)
    return _params(tree, cfg)


def to_hf_gpt2_state_dict(params: dict) -> dict:
    """The port's gpt2 params -> HF GPT-2 (Conv1D layout) naming, numpy
    arrays, with the tied ``lm_head.weight``: the inverse of
    ``from_hf_gpt2_state_dict``."""
    tree = _stacked(params, "gpt2")
    out = {
        "wte.weight": tree["wte"],
        "wpe.weight": tree["wpe"],
        "ln_f.weight": tree["ln_f"]["scale"],
        "ln_f.bias": tree["ln_f"]["bias"],
        "lm_head.weight": tree["wte"],
    }
    blocks = tree["blocks"]
    n_layer = len(params["blocks"])
    for hf_key, path in _HF_BLOCK_KEYS.items():
        stacked = interop._get(blocks, path)
        if path[-2:] == ("c_attn", "kernel"):
            stacked = stacked.reshape(stacked.shape[0], stacked.shape[1], -1)
        elif path[-2:] == ("c_attn", "bias"):
            stacked = stacked.reshape(stacked.shape[0], -1)
        for layer in range(n_layer):
            out[f"h.{layer}.{hf_key}"] = stacked[layer]
    return out


_HF_LLAMA_BLOCK_KEYS = {
    # HF torch-Linear [out, in] -> the port's [in, out] kernels: transposed.
    "input_layernorm.weight": ("ln_attn", "scale"),
    "self_attn.q_proj.weight": ("attn", "wq"),
    "self_attn.k_proj.weight": ("attn", "wk"),
    "self_attn.v_proj.weight": ("attn", "wv"),
    "self_attn.o_proj.weight": ("attn", "wo"),
    "post_attention_layernorm.weight": ("ln_mlp", "scale"),
    "mlp.gate_proj.weight": ("mlp", "gate"),
    "mlp.up_proj.weight": ("mlp", "up"),
    "mlp.down_proj.weight": ("mlp", "down"),
}

# Mixtral expert names -> the port's expert leaves (module docstring).
_MIXTRAL_EXPERT_KEYS = {
    "w_gate": "w1",
    "w_in": "w3",
    "w_out": "w2",
}


def from_hf_llama_state_dict(sd: dict, cfg: ModelConfig) -> dict:
    """An HF LlamaForCausalLM (or, for ``cfg.n_experts > 0``,
    MixtralForCausalLM) state dict -> the port's llama params.

    Projections transpose to [in, out]; head order and the half-split RoPE
    match HF, so nothing is permuted. A tied checkpoint (no
    ``lm_head.weight``) reuses ``embed_tokens`` for the head. Mixtral's
    routing (top-k over a full softmax, renormalised) is ``ops/moe``'s
    top_k > 1 gating exactly; at top_k 1 the port gates by the raw
    probability where Mixtral's weight is 1.0, so ``moe_top_k`` 1 is
    refused. For HF's no-drop routing set ``expert_capacity_factor >=
    n_experts / moe_top_k``."""
    sd = {k: _to_np(v) for k, v in sd.items()}
    sd = {(k[len("model."):] if k.startswith("model.") else k): v
          for k, v in sd.items()}
    wte = sd["embed_tokens.weight"]
    if wte.shape != (cfg.vocab_size, cfg.n_embd):
        raise ValueError(
            f"embed_tokens shape {wte.shape} != "
            f"({cfg.vocab_size}, {cfg.n_embd})"
        )
    lm_head = sd.get("lm_head.weight", sd["embed_tokens.weight"])
    tree: dict = {
        "wte": wte,
        "ln_f": {"scale": sd["norm.weight"]},
        "lm_head": np.ascontiguousarray(lm_head.T),
        "blocks": {},
    }
    block_keys = dict(_HF_LLAMA_BLOCK_KEYS)
    if cfg.n_experts:
        block_keys = {k: v for k, v in block_keys.items() if v[0] != "mlp"}
    for hf_key, path in block_keys.items():
        per_layer = []
        for layer in range(cfg.n_layer):
            name = f"layers.{layer}.{hf_key}"
            if name not in sd:
                raise KeyError(f"missing {name!r} in state dict")
            arr = sd[name]
            if hf_key.endswith("proj.weight"):
                arr = arr.T
            per_layer.append(arr)
        _set_nested(tree["blocks"], path, np.stack(per_layer))

    if cfg.n_experts:
        if cfg.moe_top_k == 1:
            raise ValueError(
                "Mixtral import needs moe_top_k >= 2: at top_k=1 the port's "
                "Switch gating (raw prob) differs from Mixtral's "
                "renormalised gating (weight 1.0), so HF parity is "
                "impossible"
            )
        moe = "block_sparse_moe"

        def fetch(name: str) -> np.ndarray:
            if name not in sd:
                raise KeyError(f"missing {name!r} in state dict")
            return sd[name]

        mlp = {"router": np.stack([
            fetch(f"layers.{i}.{moe}.gate.weight").T
            for i in range(cfg.n_layer)
        ])}
        for ours, hf_w in _MIXTRAL_EXPERT_KEYS.items():
            mlp[ours] = np.stack([
                np.stack([
                    fetch(f"layers.{i}.{moe}.experts.{j}.{hf_w}.weight").T
                    for j in range(cfg.n_experts)
                ])
                for i in range(cfg.n_layer)
            ])
        tree["blocks"]["mlp"] = mlp
        got_r = mlp["router"].shape
        expect_r = (cfg.n_layer, cfg.n_embd, cfg.n_experts)
        if got_r != expect_r:
            raise ValueError(
                f"router stacked shape {got_r} != {expect_r} — config "
                "n_experts mismatch with the checkpoint"
            )
        expect_e = (cfg.n_layer, cfg.n_experts, cfg.n_embd, cfg.inner_dim)
        for ours in ("w_gate", "w_in"):
            got_e = mlp[ours].shape
            if got_e != expect_e:
                raise ValueError(
                    f"{ours} stacked shape {got_e} != {expect_e} — config "
                    "n_inner/intermediate_size mismatch with the checkpoint"
                )

    got = tree["blocks"]["attn"]["wk"].shape
    expect = (cfg.n_layer, cfg.n_embd, cfg.kv_heads * cfg.head_dim)
    if got != expect:
        raise ValueError(
            f"wk stacked shape {got} != {expect} — config kv_heads/head_dim "
            "mismatch with the checkpoint"
        )
    return _params(tree, cfg)


def to_hf_llama_state_dict(params: dict, *, tied: bool | None = None) -> dict:
    """The port's llama params -> HF naming (torch-Linear [out, in],
    ``model.``-prefixed, numpy arrays): the inverse of
    ``from_hf_llama_state_dict``, dense or Mixtral (a ``router`` leaf in
    the MLP means Mixtral naming). ``tied`` None: the head is left out
    when it equals the embedding by value, as a tied HF checkpoint has it;
    pass False or True to decide."""
    tree = _stacked(params, "llama")
    blocks = tree["blocks"]
    wte = tree["wte"]
    head = tree["lm_head"].T
    out = {
        "model.embed_tokens.weight": wte,
        "model.norm.weight": tree["ln_f"]["scale"],
    }
    if tied is None:
        tied = np.array_equal(head, wte)
    if not tied:
        out["lm_head.weight"] = head
    n_layer = len(params["blocks"])
    moe = "router" in blocks["mlp"]
    for hf_key, path in _HF_LLAMA_BLOCK_KEYS.items():
        if moe and path[0] == "mlp":
            continue
        stacked = interop._get(blocks, path)
        for layer in range(n_layer):
            arr = stacked[layer]
            if hf_key.endswith("proj.weight"):
                arr = arr.T
            out[f"model.layers.{layer}.{hf_key}"] = arr
    if moe:
        router = blocks["mlp"]["router"]  # [L, D, X]
        for layer in range(n_layer):
            base = f"model.layers.{layer}.block_sparse_moe"
            out[f"{base}.gate.weight"] = router[layer].T
            for ours, hf_w in _MIXTRAL_EXPERT_KEYS.items():
                for j in range(router.shape[-1]):
                    out[f"{base}.experts.{j}.{hf_w}.weight"] = (
                        blocks["mlp"][ours][layer, j].T
                    )
    return out


def from_hf_pretrained(model_name: str = "gpt2",
                       cfg: ModelConfig | None = None):
    """Load an HF checkpoint from a local directory (``model_name``; no
    download is attempted) and convert it: GPT-2 or Llama/Mistral/Mixtral,
    told apart by the HF config. Returns (params, cfg). A Mistral-family
    sliding window clamps ``n_ctx`` to the window (full causal attention
    differs from HF beyond it); an explicit ``cfg`` past it is refused."""
    from transformers import AutoConfig, AutoModelForCausalLM

    from pytorch_distributed_tpu_torch.config import model_config

    hf_cfg = AutoConfig.from_pretrained(model_name, local_files_only=True)
    is_llama = hf_cfg.model_type in ("llama", "mistral", "mixtral")
    sliding = getattr(hf_cfg, "sliding_window", None)
    if hf_cfg.model_type in ("mistral", "mixtral") and sliding:
        if cfg is not None and cfg.n_ctx > int(sliding):
            raise ValueError(
                f"cfg.n_ctx={cfg.n_ctx} exceeds {model_name!r}'s sliding "
                f"window ({sliding}); pass cfg with n_ctx <= {sliding} "
                "(full-causal attention diverges from HF beyond it)"
            )
        import warnings

        warnings.warn(
            f"{model_name!r} uses sliding-window attention (window="
            f"{sliding}); importing with full causal attention and n_ctx "
            f"clamped to the window — longer sequences are rejected.",
            stacklevel=2,
        )
    if cfg is None:
        if is_llama:
            n_ctx = hf_cfg.max_position_embeddings
            if hf_cfg.model_type in ("mistral", "mixtral") and sliding:
                n_ctx = min(n_ctx, int(sliding))
            cfg = model_config("llama3-1b").replace(
                vocab_size=hf_cfg.vocab_size,
                n_ctx=n_ctx,
                n_embd=hf_cfg.hidden_size,
                n_layer=hf_cfg.num_hidden_layers,
                n_head=hf_cfg.num_attention_heads,
                n_kv_head=hf_cfg.num_key_value_heads,
                n_inner=hf_cfg.intermediate_size,
                rope_theta=hf_cfg.rope_theta,
                layer_norm_epsilon=hf_cfg.rms_norm_eps,
            )
            if hf_cfg.model_type == "mixtral":
                # Capacity at the no-drop bound (cf = X / k: T slots per
                # expert), HF's dense per-token routing exactly.
                cfg = cfg.replace(
                    n_experts=hf_cfg.num_local_experts,
                    moe_top_k=hf_cfg.num_experts_per_tok,
                    expert_capacity_factor=(
                        float(hf_cfg.num_local_experts)
                        / hf_cfg.num_experts_per_tok
                    ),
                )
        else:
            cfg = model_config("gpt2").replace(
                vocab_size=hf_cfg.vocab_size,
                n_ctx=hf_cfg.n_positions,
                n_embd=hf_cfg.n_embd,
                n_layer=hf_cfg.n_layer,
                n_head=hf_cfg.n_head,
            )
    model = AutoModelForCausalLM.from_pretrained(model_name,
                                                 local_files_only=True)
    convert = from_hf_llama_state_dict if is_llama else from_hf_gpt2_state_dict
    return convert(model.state_dict(), cfg), cfg
