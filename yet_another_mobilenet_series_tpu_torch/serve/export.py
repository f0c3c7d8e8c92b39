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

An int8-weight bundle (``export_bundle(quant_weights="int8")``,
``serve/quant.py``) stores each quantized conv/dense pair as ``w_q`` (int8)
+ ``w_scale`` (f32 per output channel) + the f32 bias, as the JAX package
does, and the digest covers them alike. :func:`prepare_folded` keeps them
int8 on the device, and :func:`apply_folded` dequantizes ``w_q.float() *
w_scale`` in the forward (the depthwise taps too, before the fused kernel,
which takes float taps).

Live AtomNAS masks with dead atoms are hard-applied before the fold by the
rematerialisation surgery (``nas/rematerialize.py``), so a searched bundle
holds only its surviving branches. :func:`export_checkpoint` exports a
checkpoint of the port (``ckpt/manager.py``): spec first, then the weights,
the EMA shadow by default.
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

from ..ckpt.manager import CheckpointManager
from ..models import convert
from ..models.convert import flatten_tree, unflatten_tree
from ..models.serialize import network_from_dict, network_to_dict, spec_is_inference
from ..models.specs import Network
from ..nas.masking import masks_to_host
from ..nas.rematerialize import rematerialize
from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..ops.activations import get_activation
from ..ops.fused_depthwise import fused_depthwise, out_size
from ..ops.layers import bn_scale_shift, global_avg_pool
from ..utils.device import resolve_device

# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------


def _fold_conv(conv_p: dict, bn_p: dict, bn_s: dict, eps: float) -> dict:
    """conv -> BN(eval) collapses to conv' with bias: the BN affine is per
    OUTPUT channel, the first axis of every OIHW kernel."""
    scale, shift = bn_scale_shift(bn_p["gamma"], bn_p["beta"], bn_s["mean"], bn_s["var"], eps)
    return {"w": conv_p["w"] * scale[:, None, None, None], "b": shift}


def fold_block(blk, pb: dict, sb: dict) -> dict:
    """One InvertedResidual block's folded params from its params and BN
    state (float32 CPU tensors): the expand and project convs fold their
    BN, and each depthwise branch folds its slice of the shared dw BN."""
    fb: dict[str, Any] = {}
    if blk.has_expand:
        fb["expand"] = _fold_conv(pb["expand"], pb["expand_bn"], sb["expand_bn"], blk.bn_eps)
    dw_scale, dw_shift = bn_scale_shift(
        pb["dw_bn"]["gamma"], pb["dw_bn"]["beta"], sb["dw_bn"]["mean"], sb["dw_bn"]["var"], blk.bn_eps)
    for bi, kz, g, off in blk._branches():
        key = f"dw{bi}_k{kz}"
        fb[key] = {"w": pb[key]["w"] * dw_scale[off: off + g, None, None, None], "b": dw_shift[off: off + g]}
    if blk.se_channels:
        fb["se"] = pb["se"]
    fb["project"] = _fold_conv(pb["project"], pb["project_bn"], sb["project_bn"], blk.bn_eps)
    return fb


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
    out["blocks"] = {str(i): fold_block(blk, params["blocks"][str(i)], state["blocks"][str(i)])
                     for i, blk in enumerate(net.blocks)}
    if net.head is not None:
        out["head"] = _fold_conv(params["head"]["conv"], params["head"]["bn"], state["head"]["bn"], net.head.bn_eps)
    if net.feature is not None:
        out["feature"] = params["feature"]
    out["classifier"] = params["classifier"]
    return out


# ---------------------------------------------------------------------------
# the folded forward (what the engine runs)
# ---------------------------------------------------------------------------


def prepare_folded(net: Network, folded: dict, *, device: torch.device | str = "cuda",
                   compute_dtype: torch.dtype = torch.float32) -> dict:
    """The folded tree as :func:`apply_folded` reads it, made once per
    bundle and device and never per call: every tensor on ``device``, the
    stem/expand/project/head conv weights and biases in ``compute_dtype``,
    the conv weights in channels_last memory like the activations, and each
    depthwise branch reduced to the fused kernel's operands
    ``{'taps': (k, k, C) f32, 'b': (C,) f32, 'ones': (C,) f32}``. SE,
    feature and classifier stay float32 (the forward casts the feature).
    An int8 pair keeps ``w_q`` int8 (a depthwise one as ``taps_q``, (k, k,
    C)) beside its f32 ``w_scale``; the forward dequantizes it. ``device``
    is the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    out: dict[str, Any] = {"stem": _prepare_conv(folded["stem"], dev, compute_dtype)}
    out["blocks"] = {str(i): prepare_block(blk, folded["blocks"][str(i)], device=dev, compute_dtype=compute_dtype)
                     for i, blk in enumerate(net.blocks)}
    if net.head is not None:
        out["head"] = _prepare_conv(folded["head"], dev, compute_dtype)
    if net.feature is not None:
        out["feature"] = _prepare_dense(folded["feature"], dev)
    out["classifier"] = _prepare_dense(folded["classifier"], dev)
    return out


def _put(t, dev, dtype=torch.float32):
    return t.detach().to(device=dev, dtype=dtype).contiguous()


def _prepare_conv(p: dict, dev, compute_dtype) -> dict:
    if "w_q" in p:
        return {"w_q": _put(p["w_q"], dev, torch.int8), "w_scale": _put(p["w_scale"], dev),
                "b": _put(p["b"], dev, compute_dtype)}
    # channels_last, like the activations: a convolution otherwise copies an
    # OIHW k > 1 weight into that format on every call
    w = _put(p["w"], dev, compute_dtype).contiguous(memory_format=torch.channels_last)
    return {"w": w, "b": _put(p["b"], dev, compute_dtype)}


def _prepare_dense(p: dict, dev) -> dict:
    return {k: _put(v, dev, torch.int8 if k == "w_q" else torch.float32) for k, v in p.items()}


def prepare_block(blk, pb: dict, *, device: torch.device | str = "cuda",
                  compute_dtype: torch.dtype = torch.float32) -> dict:
    """One block's folded params as :func:`apply_folded_block` reads them
    (the block's part of :func:`prepare_folded`)."""
    dev = resolve_device(device)
    fb: dict[str, Any] = {}
    if blk.has_expand:
        fb["expand"] = _prepare_conv(pb["expand"], dev, compute_dtype)
    for bi, kz, g, _ in blk._branches():
        key = f"dw{bi}_k{kz}"
        p = pb[key]
        fb[key] = {"b": _put(p["b"], dev), "ones": torch.ones(g, device=dev)}
        if "w_q" in p:
            taps_q = p["w_q"][:, 0].permute(1, 2, 0)  # (C, 1, k, k) -> (k, k, C), as depthwise_taps
            fb[key].update(taps_q=_put(taps_q, dev, torch.int8), w_scale=_put(p["w_scale"], dev))
        else:
            fb[key]["taps"] = _put(convert.depthwise_taps(p["w"]), dev)
    if blk.se_channels:
        fb["se"] = {name: _prepare_dense(p, dev) for name, p in pb["se"].items()}
    fb["project"] = _prepare_conv(pb["project"], dev, compute_dtype)
    return fb


def _conv_weight(p: dict, compute_dtype) -> torch.Tensor:
    """A prepared conv's weight; an int8 pair dequantizes here, per output
    channel (the first axis of OIHW), into the f32 tree's dtype and memory
    format, so it computes exactly what its dequantized f32 bundle does."""
    if "w_q" not in p:
        return p["w"]
    w = p["w_q"].float() * p["w_scale"][:, None, None, None]
    return w.to(compute_dtype).contiguous(memory_format=torch.channels_last)


def _dense_params(p: dict) -> dict:
    """A prepared dense layer's params with an int8 weight dequantized over
    its output axis (the last of (in, out))."""
    if "w_q" not in p:
        return p
    return {"w": p["w_q"].float() * p["w_scale"], **{k: v for k, v in p.items() if k not in ("w_q", "w_scale")}}


def _dense(layer, p: dict, h: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """A dense layer of the folded forward. On the CPU each row is its own
    one-row product: the CPU BLAS picks its kernel by the row count and
    computes rows in pairs, so a row's bits would depend on its place in the
    batch and on its neighbours, which the engine's coalescing picks by
    timing. Row by row, a request's answer is the same however it was
    batched. On a card it is one product."""
    p = _dense_params(p)
    if h.device.type != "cpu":
        return layer.apply(p, h, compute_dtype=compute_dtype)
    return torch.cat([layer.apply(p, row, compute_dtype=compute_dtype) for row in h.split(1)])


def _nhwc(h: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> the contiguous (N, H, W, C) tensor the kernel takes:
    a view, with no copy, of a channels_last tensor."""
    return h.permute(0, 2, 3, 1).contiguous()


def _conv_bias_act(p, h, k, stride, act_name, compute_dtype):
    # weights and bias are already in the compute dtype (prepare_folded)
    w = _conv_weight(p, compute_dtype)
    return get_activation(act_name)(F.conv2d(h, w, p["b"], stride=stride, padding=k // 2))


def apply_folded_block(blk, pb: dict, h: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """One block of :func:`apply_folded`: (N, C, H, W) channels_last in the
    compute dtype -> the block's output, its depthwise stage one launch of
    the fused kernel per branch."""
    hin = h
    if blk.has_expand:
        h = _conv_bias_act(pb["expand"], h, 1, 1, blk.active_fn, compute_dtype)
    xs = _nhwc(h)
    # each branch (one, or AtomNAS's several) reads its channel slice of xs
    # and writes its slice of one output, in place (no slice copy, no concat)
    n, hh, ww, c = xs.shape
    y = xs.new_empty((n, out_size(hh, blk.stride), out_size(ww, blk.stride), c))
    for bi, kz, g, off in blk._branches():
        p = pb[f"dw{bi}_k{kz}"]
        taps = p["taps"] if "taps" in p else p["taps_q"].float() * p["w_scale"]
        fused_depthwise(xs[..., off: off + g], taps, p["ones"], p["b"], p["ones"], blk.stride,
                        blk.active_fn, out=y[..., off: off + g])
    h = y.permute(0, 3, 1, 2)
    if blk.se_channels:
        h = blk._se().apply(pb["se"], h)
    h = _conv_bias_act(pb["project"], h, 1, 1, blk.project_act, compute_dtype)
    if blk.has_residual:
        h = h + hin.to(h.dtype)
    return h


def apply_folded(net: Network, params: dict, x: torch.Tensor, *, compute_dtype=torch.float32,
                 collect: dict | None = None) -> torch.Tensor:
    """Inference forward over prepared folded params (:func:`prepare_folded`):
    conv(+bias) -> act, no BN, no dropout, no masks. x (N, H, W, 3) NHWC on
    the params' device -> (N, num_classes) float32 logits.

    Inside, ``x.permute(0, 3, 1, 2)`` of the NHWC input is already
    channels_last, so the dense convs run through ``F.conv2d`` on that
    memory format with no copy, and each depthwise stage is one call of the
    fused kernel per branch with the activation fused in (exact: the
    activation acts per channel); the branches of an AtomNAS block read and
    write their channel slices of one input and one output in place.

    ``collect`` (a dict, eager calls only) receives per-stage activation
    (min, max) pairs under the JAX package's names (``stem``, ``block<i>``,
    ``head``, ``logits``): the int8 export's calibration instrument."""

    def observe(name, h):
        if collect is not None:
            collect[name] = (float(h.min()), float(h.max()))
        return h

    stem = net.stem
    h = observe("stem", _conv_bias_act(params["stem"], x.to(compute_dtype).permute(0, 3, 1, 2), stem.kernel_size,
                                       stem.stride, stem.active_fn, compute_dtype))
    for i, blk in enumerate(net.blocks):
        h = observe(f"block{i}", apply_folded_block(blk, params["blocks"][str(i)], h, compute_dtype=compute_dtype))
    if net.head is not None:
        h = observe("head", _conv_bias_act(params["head"], h, net.head.kernel_size, net.head.stride,
                                           net.head.active_fn, compute_dtype))
    h = global_avg_pool(h)
    if net.feature is not None:
        h = _dense(net.feature, params["feature"], h, compute_dtype=compute_dtype)
        h = get_activation(net.feature_act)(h)
    return observe("logits", _dense(net.classifier, params["classifier"], h.float()))


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
    port's layouts (float32 CPU tensors; ``w_q`` int8 in an int8 bundle)."""

    net: Network
    params: dict
    meta: dict[str, Any]

    @property
    def quant(self) -> dict | None:
        """The int8 export's provenance block — None for an f32 bundle."""
        return self.meta.get("quant")

    @property
    def weights(self) -> str:
        """Weight storage of the bundle: "int8" when any pair is quantized."""
        return "int8" if any(k.endswith("/w_q") for k in flatten_tree(self.params)) else "float32"

    @property
    def model_name(self) -> str | None:
        """The zoo identity stamped at export (``export_bundle(...,
        model_name=)``); None for a bundle exported without one."""
        return self.meta.get("model_name")

    @property
    def digest(self) -> str | None:
        """The content digest stamped at export and verified by
        :func:`load_bundle` (:func:`bundle_digest`, the same string the JAX
        package computes for the same bundle); the fleet lease advertises it
        per model name."""
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
    calib_images: np.ndarray | None = None,
    int8_top1_min: float = 0.98,
    model_name: str | None = None,
    device: str | torch.device = "cuda",
) -> str:
    """Fold (params, state) and write a bundle directory that both packages
    load. ``masks`` (a live AtomNAS mask dict, device tensors or numpy) that
    hold dead atoms are hard-applied first by ``nas/rematerialize.py``, as
    the JAX package does, and ``meta.json["prune"]`` records the surgery;
    pass the EMA trees as (params, state) to export the shadow weights.

    ``quant_weights="int8"`` runs the gated post-training quantization pass
    (``serve/quant.py``) on the JAX-layout fold, as the JAX package does:
    ``calib_images`` (required) go through the f32 and the int8 forward,
    the export is refused below ``int8_top1_min`` top-1 agreement, and the
    report lands in ``meta.json["quant"]``. The calibration forward runs on
    ``device``, the card unless the caller asks for the CPU; a float32
    export does no device work."""
    from .quant import WEIGHT_DTYPES, calibrate_and_quantize

    if quant_weights not in WEIGHT_DTYPES:
        raise ValueError(f"quant_weights must be one of {WEIGHT_DTYPES}, got {quant_weights!r}")
    with obs_trace.get_tracer().span("serve/export", "serve"):
        meta: dict[str, Any] = dict(extra_meta or {})
        if masks:
            np_masks = masks_to_host(masks)
            if any(m.min() == 0 for m in np_masks.values()):
                net, params, state, _, _, report = rematerialize(net, params, state, np_masks)
                meta["prune"] = {"atoms_before": report.atoms_before, "atoms_after": report.atoms_after,
                                 "dropped_blocks": report.dropped_blocks}
        flat = convert.to_jax(fold_network(net, params, state))
        if quant_weights == "int8":
            if calib_images is None:
                raise ValueError("int8 export needs a calibration batch (calib_images)")
            quantized, meta["quant"] = calibrate_and_quantize(
                net, unflatten_tree(flat), calib_images, top1_min=int8_top1_min, device=device)
            flat = flatten_tree(quantized)
            get_registry().counter("serve.int8_exports").inc()
        os.makedirs(out_dir, exist_ok=True)
        spec_dict = network_to_dict(net, inference=True)
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


def export_checkpoint(
    ckpt_dir: str,
    out_dir: str,
    *,
    use_ema: bool = True,
    step: int | None = None,
    quant_weights: str = "float32",
    calib_images: np.ndarray | None = None,
    int8_top1_min: float = 0.98,
    device: str | torch.device = "cuda",
) -> str:
    """Checkpoint directory -> bundle: the two-phase restore (the spec first,
    so a pruned network is rebuilt at its shape), the newest step unless
    ``step``, the EMA shadow when ``use_ema`` and the checkpoint has one,
    dead masks hard-applied, then :func:`export_bundle` (the int8 knobs and
    ``device``, where the calibration forward runs, pass straight through).
    ``meta.json`` records the source, step, whether the EMA was used and
    the epoch, as the JAX package's does."""
    mgr = CheckpointManager(ckpt_dir)
    try:
        spec = mgr.restore_spec(step)
        if spec is None:
            raise FileNotFoundError(f"no checkpoint found under {ckpt_dir!r}")
        found_step, net, extra = spec
        # as saved: export reads weight trees and needs no optimizer skeleton
        tree = mgr.restore_tree(found_step)
    finally:
        mgr.close()
    ema_ok = use_ema and tree.get("ema_params") is not None
    params = tree["ema_params"] if ema_ok else tree["params"]
    state = tree["ema_state"] if ema_ok else tree["state"]
    return export_bundle(
        net, params, state, out_dir,
        masks=tree.get("masks") or None,
        extra_meta={"source": ckpt_dir, "step": int(tree["step"]), "ema": ema_ok,
                    "epoch": (extra or {}).get("epoch")},
        quant_weights=quant_weights, calib_images=calib_images, int8_top1_min=int8_top1_min, device=device,
    )


def load_bundle(bundle_dir: str) -> InferenceBundle:
    """Read a bundle written by either package (int8 weight pairs included);
    verify its digest; refuse training specs."""
    with open(os.path.join(bundle_dir, "spec.json")) as f:
        spec = json.load(f)
    if not spec_is_inference(spec):
        raise ValueError(
            f"{bundle_dir!r} is not an inference bundle (spec lacks the folded-BN "
            "marker); export it with serve.export first")
    net = network_from_dict(spec)
    with np.load(os.path.join(bundle_dir, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
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
