"""Folded-BN bundles and the folded forward: the torch twin of
``yet_another_mobilenet_series_tpu/serve/export.py``.

The BN fold turns every (conv, eval BN) pair into a conv with a bias:
``w' = w * scale`` over the output channels and ``b' = shift``, with
``(scale, shift) = bn_scale_shift(gamma, beta, mean, var)``. The serving
forward (:func:`apply_folded`) then has no BN at all.

The bundle format on disk is the JAX package's, so a bundle exported by
either package loads in the other::

    bundle/
      spec.json     network_to_dict(net, inference=True)  (schema v2)
      weights.npz   folded params in the JAX layouts (HWIO convs), paths '/'-joined
      meta.json     provenance, and the content digest load_bundle verifies

In memory the port holds the folded tree in its own layouts
(``models/convert.py``). :func:`prepare_folded` turns that tree into what
the forward reads, once per bundle and device: tensors on the device, the
dense conv weights in the compute dtype, and for each depthwise branch the
kernel's operands — the (k, k, C) taps, the bias as the shift, and a ones
vector as the scale and the mask.

Not ported yet, and refused with a clear error: export of live AtomNAS
masks that need the rematerialisation surgery (ROADMAP queue 1, item 7),
int8 weights on export or on load (queue 1b, S4), and export from a
checkpoint (queue 1, item 9).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..models import convert
from ..models.convert import flatten_tree, unflatten_tree  # noqa: F401 — the JAX module's public names
from ..models.serialize import network_from_dict, network_to_dict, spec_is_inference
from ..models.specs import Network
from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..ops.activations import get_activation
from ..ops.fused_depthwise import fused_depthwise, out_size
from ..ops.layers import bn_scale_shift, global_avg_pool

# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------


def _fold_conv(conv_p: dict, bn_p: dict, bn_s: dict, eps: float) -> dict:
    """conv -> BN(eval) collapses to conv' with bias: the BN affine is per
    OUTPUT channel, the first axis of every OIHW kernel."""
    scale, shift = bn_scale_shift(bn_p["gamma"], bn_p["beta"], bn_s["mean"], bn_s["var"], eps)
    return {"w": conv_p["w"] * scale[:, None, None, None], "b": shift}


def fold_network(net: Network, params: dict, state: dict) -> dict:
    """Folded serving params (port layouts, float32 CPU tensors): every
    (conv, BN) pair becomes {'w', 'b'}; SE and dense layers pass through.
    The dw branches share one concatenated dw_bn, so each branch folds its
    slice of the (scale, shift) vectors."""

    def cpu(tree):
        return {k: cpu(v) if isinstance(v, dict) else v.detach().to("cpu", torch.float32)
                for k, v in tree.items()}

    params, state = cpu(params), cpu(state)
    out: dict[str, Any] = {}
    out["stem"] = _fold_conv(params["stem"]["conv"], params["stem"]["bn"], state["stem"]["bn"], net.stem.bn_eps)
    blocks: dict[str, Any] = {}
    for i, blk in enumerate(net.blocks):
        pb, sb = params["blocks"][str(i)], state["blocks"][str(i)]
        fb: dict[str, Any] = {}
        if blk.has_expand:
            fb["expand"] = _fold_conv(pb["expand"], pb["expand_bn"], sb["expand_bn"], blk.bn_eps)
        dw_scale, dw_shift = bn_scale_shift(
            pb["dw_bn"]["gamma"], pb["dw_bn"]["beta"], sb["dw_bn"]["mean"], sb["dw_bn"]["var"], blk.bn_eps)
        for bi, kz, g, off in blk._branches():
            key = f"dw{bi}_k{kz}"
            fb[key] = {"w": pb[key]["w"] * dw_scale[off: off + g, None, None, None],
                       "b": dw_shift[off: off + g]}
        if blk.se_channels:
            fb["se"] = pb["se"]
        fb["project"] = _fold_conv(pb["project"], pb["project_bn"], sb["project_bn"], blk.bn_eps)
        blocks[str(i)] = fb
    out["blocks"] = blocks
    if net.head is not None:
        out["head"] = _fold_conv(params["head"]["conv"], params["head"]["bn"], state["head"]["bn"], net.head.bn_eps)
    if net.feature is not None:
        out["feature"] = params["feature"]
    out["classifier"] = params["classifier"]
    return out


# ---------------------------------------------------------------------------
# the folded forward (what the engine runs)
# ---------------------------------------------------------------------------


def prepare_folded(net: Network, folded: dict, *, device: torch.device | str = "cpu",
                   compute_dtype: torch.dtype = torch.float32) -> dict:
    """The folded tree as :func:`apply_folded` reads it, made once per
    bundle and device and never per call: every tensor on ``device``, the
    stem/expand/project/head conv weights and biases in ``compute_dtype``,
    the conv weights in channels_last memory like the activations, and each
    depthwise branch reduced to the fused kernel's operands
    ``{'taps': (k, k, C) f32, 'b': (C,) f32, 'ones': (C,) f32}``. SE,
    feature and classifier stay float32 (the forward casts the feature)."""
    dev = torch.device(device)

    def put(t, dtype=torch.float32):
        return t.detach().to(device=dev, dtype=dtype).contiguous()

    def conv(p):
        # channels_last, like the activations: a convolution otherwise
        # copies an OIHW k > 1 weight into that format on every call
        w = put(p["w"], compute_dtype).contiguous(memory_format=torch.channels_last)
        return {"w": w, "b": put(p["b"], compute_dtype)}

    def dense(p):
        return {k: put(v) for k, v in p.items()}

    out: dict[str, Any] = {"stem": conv(folded["stem"])}
    blocks = {}
    for i, blk in enumerate(net.blocks):
        pb = folded["blocks"][str(i)]
        fb: dict[str, Any] = {}
        if blk.has_expand:
            fb["expand"] = conv(pb["expand"])
        for bi, kz, g, _ in blk._branches():
            key = f"dw{bi}_k{kz}"
            fb[key] = {"taps": put(convert.depthwise_taps(pb[key]["w"])), "b": put(pb[key]["b"]),
                       "ones": torch.ones(g, device=dev)}
        if blk.se_channels:
            fb["se"] = {name: dense(p) for name, p in pb["se"].items()}
        fb["project"] = conv(pb["project"])
        blocks[str(i)] = fb
    out["blocks"] = blocks
    if net.head is not None:
        out["head"] = conv(folded["head"])
    if net.feature is not None:
        out["feature"] = dense(folded["feature"])
    out["classifier"] = dense(folded["classifier"])
    return out


def _nhwc(h: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> the contiguous (N, H, W, C) tensor the kernel takes:
    a view, with no copy, of a channels_last tensor."""
    return h.permute(0, 2, 3, 1).contiguous()


def apply_folded(net: Network, params: dict, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """Inference forward over prepared folded params (:func:`prepare_folded`):
    conv(+bias) -> act, no BN, no dropout, no masks. x (N, H, W, 3) NHWC on
    the params' device -> (N, num_classes) float32 logits.

    Inside, ``x.permute(0, 3, 1, 2)`` of the NHWC input is already
    channels_last, so the dense convs run through ``F.conv2d`` on that
    memory format with no copy, and each depthwise stage is one call of the
    fused kernel per branch with the activation fused in (exact: the
    activation acts per channel); the branches of an AtomNAS block read and
    write their channel slices of one input and one output in place."""

    def conv_bias_act(p, h, k, stride, act_name):
        # weights and bias are already in the compute dtype (prepare_folded)
        return get_activation(act_name)(F.conv2d(h, p["w"], p["b"], stride=stride, padding=k // 2))

    stem = net.stem
    h = conv_bias_act(params["stem"], x.to(compute_dtype).permute(0, 3, 1, 2), stem.kernel_size, stem.stride,
                      stem.active_fn)
    for i, blk in enumerate(net.blocks):
        pb = params["blocks"][str(i)]
        hin = h
        if blk.has_expand:
            h = conv_bias_act(pb["expand"], h, 1, 1, blk.active_fn)
        xs = _nhwc(h)
        # each branch (one, or AtomNAS's several) reads its channel slice of
        # xs and writes its slice of one output, in place (no slice copy, no
        # concat)
        n, hh, ww, c = xs.shape
        y = xs.new_empty((n, out_size(hh, blk.stride), out_size(ww, blk.stride), c))
        for bi, kz, g, off in blk._branches():
            p = pb[f"dw{bi}_k{kz}"]
            fused_depthwise(xs[..., off: off + g], p["taps"], p["ones"], p["b"], p["ones"], blk.stride,
                            blk.active_fn, out=y[..., off: off + g])
        h = y.permute(0, 3, 1, 2)
        if blk.se_channels:
            h = blk._se().apply(pb["se"], h)
        h = conv_bias_act(pb["project"], h, 1, 1, blk.project_act)
        if blk.has_residual:
            h = h + hin.to(h.dtype)
    if net.head is not None:
        h = conv_bias_act(params["head"], h, net.head.kernel_size, net.head.stride, net.head.active_fn)
    h = global_avg_pool(h)
    if net.feature is not None:
        h = net.feature.apply(params["feature"], h, compute_dtype=compute_dtype)
        h = get_activation(net.feature_act)(h)
    return net.classifier.apply(params["classifier"], h.float())


# ---------------------------------------------------------------------------
# bundle I/O
# ---------------------------------------------------------------------------


class BundleDigestMismatch(ValueError):
    """The bundle's on-disk content no longer matches the digest stamped in
    ``meta.json`` at export: the artifact was corrupted or hand-edited."""


def bundle_digest(spec: dict, flat_params: dict[str, np.ndarray]) -> str:
    """Deterministic content digest of a bundle (the JAX package's): the
    canonicalized spec JSON plus every weight's path/dtype/shape/bytes, in
    sorted path order, over the JAX-layout arrays that ``weights.npz`` holds."""
    h = hashlib.sha256()
    h.update(json.dumps(spec, sort_keys=True).encode())
    for path in sorted(flat_params):
        a = np.ascontiguousarray(flat_params[path])
        h.update(path.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


@dataclass(frozen=True)
class InferenceBundle:
    """A loaded serving artifact: the Network spec + folded params in the
    port's layouts (float32 CPU tensors)."""

    net: Network
    params: dict
    meta: dict[str, Any]

    @property
    def digest(self) -> str | None:
        return self.meta.get("digest")


def export_bundle(
    net: Network,
    params: dict,
    state: dict,
    out_dir: str,
    *,
    masks: dict | None = None,
    extra_meta: dict[str, Any] | None = None,
    quant_weights: str = "float32",
    model_name: str | None = None,
) -> str:
    """Fold (params, state) and write a bundle directory that both packages
    load. ``masks`` that are all ones are accepted (nothing to prune); masks
    with dead atoms need the rematerialisation surgery, which is not ported
    yet, and are refused, as is ``quant_weights="int8"``."""
    if quant_weights != "float32":
        raise ValueError(f"quant_weights={quant_weights!r}: int8 weight export is not ported yet "
                         "(ROADMAP queue 1b, S4: uint8 wire and int8 weights)")
    if masks and any(float(torch.as_tensor(m).min()) == 0.0 for m in masks.values()):
        raise ValueError("masks with dead atoms need the rematerialisation surgery, which is not "
                         "ported yet (ROADMAP queue 1, item 7: AtomNAS search)")
    with obs_trace.get_tracer().span("serve/export", "serve"):
        meta: dict[str, Any] = dict(extra_meta or {})
        folded = fold_network(net, params, state)
        os.makedirs(out_dir, exist_ok=True)
        spec_dict = network_to_dict(net, inference=True)
        flat = convert.to_jax(folded)
        if model_name is not None:
            meta["model_name"] = model_name
        meta["digest"] = bundle_digest(spec_dict, flat)
        with open(os.path.join(out_dir, "spec.json"), "w") as f:
            json.dump(spec_dict, f, indent=1)
        np.savez(os.path.join(out_dir, "weights.npz"), **flat)
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1, default=str)
    get_registry().counter("serve.exports").inc()
    return out_dir


def load_bundle(bundle_dir: str) -> InferenceBundle:
    """Read a bundle written by either package; verify its digest; refuse
    training specs and int8 weights."""
    with open(os.path.join(bundle_dir, "spec.json")) as f:
        spec = json.load(f)
    if not spec_is_inference(spec):
        raise ValueError(
            f"{bundle_dir!r} is not an inference bundle (spec lacks the folded-BN "
            "marker); export it with serve.export first")
    net = network_from_dict(spec)
    with np.load(os.path.join(bundle_dir, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    int8 = sorted(k for k in flat if k.endswith("/w_q"))
    if int8:
        raise ValueError(f"{bundle_dir!r} holds int8 weights ({int8[0]}, ...), which the port does not "
                         "serve yet (ROADMAP queue 1b, S4: uint8 wire and int8 weights)")
    meta_path = os.path.join(bundle_dir, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    stamped = meta.get("digest")
    if stamped is not None:
        actual = bundle_digest(spec, flat)
        if actual != stamped:
            raise BundleDigestMismatch(
                f"bundle {bundle_dir!r} content digest {actual} != stamped {stamped}; "
                "the artifact was modified after export — re-export it")
    return InferenceBundle(net=net, params=convert.from_jax(flat), meta=meta)
