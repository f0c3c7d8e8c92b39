"""The train and eval steps: the torch twin of
``yet_another_mobilenet_series_tpu/train/steps.py``.

One step is the reference's per-step sequence: forward, label-smoothed CE
(+ the penalty hook), backward, the optimizer update, EMA. The JAX package
compiles it into one XLA program; here it is eager PyTorch on the card,
with the optimizer and EMA over all leaves at once (``_foreach`` ops) and
no host sync: every metric stays a 0-dim tensor on the device until the
caller reads it.

Differences from the JAX step that are not semantics:

- randomness comes from an explicit ``torch.Generator`` on the batch's
  device, advanced by each step's draws (the JAX step folds ``ts.step`` into
  one key); the two streams differ, so tests compare at rate 0 or with the
  masks injected (``Network.apply(noise=...)``);
- ``train.remat`` wraps the forward in ``torch.utils.checkpoint`` (non-
  reentrant); ``remat_policy="save_conv"`` keeps the convolutions' outputs
  (and the 1x1 matmuls of ``conv1x1_dot``) through a selective-checkpoint
  policy and recomputes the BN/activation chains, like the JAX package's
  ``save_only_these_names("conv_out")``. The random draws are made before
  the checkpointed forward, so its recomputation reuses them;
- the step is functional: it returns a new TrainState and leaves the one it
  was given as it was (what the guard's rollback selects against).

Data parallel (``group``, a ``torch.distributed`` process group: the JAX
package's ``axis_name``; ``parallel/dp.py`` builds the step with it): the
BN moments are summed over the group (SyncBN) unless ``dist.sync_bn`` is
off, in which case each rank normalizes with its own statistics and every
rank keeps rank 0's running statistics; the gradients are averaged in one
bucketed all-reduce (``utils/collectives.py``), or handed un-averaged to
``sharded_update`` (the ZeRO update, ``parallel/zero.py``); the metrics are
averaged over the group. ``group=None`` is one process, the path above.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping

import torch

from ..config import Config
from ..models.convert import flatten_tree, unflatten_tree
from ..models.specs import Network
from ..nas.masking import init_masks
from ..ops.layers import BN_MODES
from ..utils import collectives
from ..utils.device import resolve_device
from .ema import ema_update
from .losses import cross_entropy_label_smooth, topk_correct
from .optim import Optimizer, apply_updates, global_norm


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor  # 0-dim int32 on the device
    params: Any
    state: Any  # BN running stats
    opt_state: Any
    ema_params: Any  # None when EMA is disabled
    ema_state: Any
    masks: Any  # {} when pruning is disabled; {block_idx(str): (expanded,)} else
    rho_mult: Any = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


# the checkpoint tree's items, one per TrainState field (ckpt/manager.py and
# the resume path both build from this)
TRAIN_STATE_FIELDS = ("step", "params", "state", "opt_state", "ema_params", "ema_state", "masks", "rho_mult")


def train_state_to_dict(ts: TrainState) -> dict:
    return {k: getattr(ts, k) for k in TRAIN_STATE_FIELDS}


def train_state_from_dict(tree: dict, device: str | torch.device | None = None) -> TrainState:
    """The inverse of :func:`train_state_to_dict`: a TrainState of the
    tree's fields, every tensor moved to ``device`` when one is given.
    ``masks`` may be missing or None (no pruning: ``{}``)."""
    def put(v):
        if v is None or device is None:
            return v
        return v.to(device) if isinstance(v, torch.Tensor) else _to(v, device)

    fields = {k: put(tree.get(k)) for k in TRAIN_STATE_FIELDS}
    fields["masks"] = fields["masks"] or {}
    return TrainState(**fields)


def _copy(tree):
    return None if tree is None else unflatten_tree({k: v.clone() for k, v in flatten_tree(tree).items()})


def _to(tree, device):
    return unflatten_tree({k: v.to(device) for k, v in flatten_tree(tree).items()})


def init_train_state(net: Network, cfg: Config, optimizer: Optimizer, generator: torch.Generator, *,
                     device: str | torch.device = "cuda") -> TrainState:
    """A fresh TrainState on ``device``: weights drawn from ``generator`` (a
    CPU generator, as ``Network.init`` takes), the optimizer's state, EMA
    shadows that are real copies, never aliases of the live tensors, and,
    when ``prune.enable`` is set, the all-alive AtomNAS masks and the
    adaptive-rho multiplier 1."""
    dev = resolve_device(device)
    params, state = net.init(generator)
    params, state = _to(params, dev), _to(state, dev)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        params=params,
        state=state,
        opt_state=optimizer.init(params),
        ema_params=_copy(params) if cfg.ema.enable else None,
        ema_state=_copy(state) if cfg.ema.enable else None,
        masks=init_masks(net, dev) if cfg.prune.enable else {},
        rho_mult=torch.ones((), device=dev) if cfg.prune.enable else None,
    )


def with_weights(ts: TrainState, cfg: Config, params, state, masks=None) -> TrainState:
    """A warm start: ``ts`` (a fresh state, its step 0 and optimizer kept)
    holding the weights and BN stats ``params``/``state`` moved to its
    device, their EMA shadows as real copies, and ``masks`` when given."""
    dev = ts.step.device
    params, state = _to(params, dev), _to(state, dev)
    return ts.replace(params=params, state=state, ema_params=_copy(params) if cfg.ema.enable else None,
                      ema_state=_copy(state) if cfg.ema.enable else None,
                      masks=ts.masks if masks is None else masks)


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _check_bn_mode(cfg: Config):
    if cfg.train.bn_mode not in BN_MODES:
        raise ValueError(f"unknown train.bn_mode {cfg.train.bn_mode!r} (valid: {BN_MODES})")


def _input_normalizer(cfg: Config):
    """Returns prep(image) -> compute-dtype tensor. Under
    ``data.transfer_uint8`` the pipeline ships raw uint8 pixels and this
    applies the f32 normalize expression of the host path on the device."""
    compute_dtype = _dtype(cfg.train.compute_dtype)
    if not cfg.data.transfer_uint8:
        return lambda image: image.to(compute_dtype)

    stats: dict = {}  # per device, copied there once

    def prep(image):
        if image.device not in stats:
            stats[image.device] = (torch.tensor(cfg.data.mean, dtype=torch.float32).to(image.device),
                                   torch.tensor(cfg.data.std, dtype=torch.float32).to(image.device))
        mean, std = stats[image.device]
        x = image.to(torch.float32) / 255.0
        return ((x - mean) / std).to(compute_dtype)

    return prep


def _beta(generator: torch.Generator, alpha: float, device) -> torch.Tensor:
    """One Beta(alpha, alpha) draw as g1 / (g1 + g2) of two Gamma(alpha)."""
    g = torch._standard_gamma(torch.full((2,), alpha, device=device), generator=generator)
    return g[0] / (g[0] + g[1])


def make_batch_mixer(cfg: Config):
    """Mixup/CutMix on the device, inside the step (the JAX package's
    ``make_batch_mixer``). None when both alphas are 0.

    mix(generator, x, labels) -> (x_mixed, labels_b, lam): per-batch lam ~
    Beta(alpha, alpha); CutMix pastes a (H*sqrt(1-lam), W*sqrt(1-lam)) box
    from the permuted batch, clipped at the borders, and returns lam adjusted
    to the pasted area. With both alphas set, each step picks one with
    p=0.5. x is NHWC."""
    m_a, c_a = cfg.optim.mixup_alpha, cfg.optim.cutmix_alpha
    if m_a < 0 or c_a < 0:
        raise ValueError(f"mixup/cutmix alphas must be >= 0, got {m_a}/{c_a}")
    if m_a == 0 and c_a == 0:
        return None

    def mix(generator, x, labels):
        dev = x.device
        n, h, w = x.shape[0], x.shape[1], x.shape[2]
        perm = torch.argsort(torch.rand(n, generator=generator, device=dev))
        x_b, y_b = x[perm], labels[perm]
        if m_a > 0 and c_a > 0:
            use_cutmix = torch.rand((), generator=generator, device=dev) < 0.5
        else:
            use_cutmix = torch.full((), c_a > 0, dtype=torch.bool, device=dev)
        one = torch.ones((), device=dev)
        lam_m = _beta(generator, m_a, dev) if m_a > 0 else one
        x_mix = lam_m.to(x.dtype) * x + (1.0 - lam_m).to(x.dtype) * x_b
        lam_c = _beta(generator, c_a, dev) if c_a > 0 else one
        cut = torch.sqrt(1.0 - lam_c)
        rh, rw = torch.round(h * cut), torch.round(w * cut)
        cy = torch.randint(0, h, (), generator=generator, device=dev)
        cx = torch.randint(0, w, (), generator=generator, device=dev)
        iy = torch.arange(h, device=dev)[None, :, None, None]
        ix = torch.arange(w, device=dev)[None, None, :, None]
        in_box = ((iy >= cy - rh // 2) & (iy < cy + (rh + 1) // 2)
                  & (ix >= cx - rw // 2) & (ix < cx + (rw + 1) // 2))
        x_cut = torch.where(in_box, x_b, x)
        lam_cut = 1.0 - in_box.float().mean()
        x_out = torch.where(use_cutmix, x_cut, x_mix)
        lam = torch.where(use_cutmix, lam_cut, lam_m).float()
        return x_out, y_b, lam

    return mix


# the ops whose outputs remat_policy="save_conv" keeps: the convolutions and
# the matmuls (the 1x1 convs of conv1x1_dot; the dense layers' are small)
def _save_conv_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    saved = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default)
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(forward, policy: str):
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if policy == "save_conv":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_conv_policy)

    def run(*args):
        return checkpoint(forward, *args, use_reentrant=False, **kw)

    return run


def make_train_step(net: Network, cfg: Config, optimizer: Optimizer, lr_fn: Callable, *,
                    penalty_fn: Callable[..., torch.Tensor] | None = None, group=None,
                    sharded_update: Callable | None = None):
    """Returns step_fn(ts, batch, generator) -> (new_ts, metrics).

    ``batch`` is {'image': (N, H, W, C), 'label': (N,)} on the device of
    ``ts``; ``generator`` is a ``torch.Generator`` on that device.
    ``penalty_fn(params, masks, rho_mult=, step=)`` is the AtomNAS hook (None
    for plain training). Every metric is a 0-dim tensor on the device.

    ``group``: this rank's data-parallel process group (None: one process);
    ``batch`` is then this rank's slice of the global batch.
    ``sharded_update(grads_local, opt_state_shard, params) -> (new_params,
    new_opt_state_shard, grad_norm)`` replaces the averaged update with the
    ZeRO one; it receives the un-averaged local gradients."""
    compute_dtype = _dtype(cfg.train.compute_dtype)
    if cfg.train.remat_policy not in ("full", "save_conv"):
        raise ValueError(f"unknown train.remat_policy {cfg.train.remat_policy!r}")
    _check_bn_mode(cfg)
    # dist.sync_bn=false: per-replica statistics in the normalization (the
    # gradients are still averaged), and rank 0's running statistics kept
    # on every rank (DDP's buffer broadcast), or the "replicated" state
    # would drift apart across ranks
    bn_group = group if cfg.dist.sync_bn else None

    def forward(params, state, x, masks, noise):
        imasks = {int(k): v for k, v in masks.items()} or None
        return net.apply(params, state, x, train=True, compute_dtype=compute_dtype, masks=imasks, noise=noise,
                         bn_mode=cfg.train.bn_mode, conv1x1_dot=cfg.train.conv1x1_dot, group=bn_group)

    if cfg.train.remat:
        forward = _checkpointed(forward, cfg.train.remat_policy)
    prep_input = _input_normalizer(cfg)
    mixer = make_batch_mixer(cfg)
    smoothing = cfg.optim.label_smoothing

    def step_fn(ts: TrainState, batch: Mapping[str, torch.Tensor], generator: torch.Generator):
        labels = batch["label"]
        x = prep_input(batch["image"])
        if mixer is not None:
            x, label_b, lam = mixer(generator, x, labels)
        noise = net.draw_noise(generator, x.shape[0], x.device)
        flat = flatten_tree(ts.params)
        keys = list(flat)
        leaves = [flat[k].detach().requires_grad_(True) for k in keys]
        params = unflatten_tree(dict(zip(keys, leaves)))
        with torch.enable_grad():
            logits, new_state = forward(params, ts.state, x, ts.masks, noise)
            ce = cross_entropy_label_smooth(logits, labels, smoothing)
            if mixer is not None:
                # CE is linear in the target, so the label mix is the loss mix
                ce = lam * ce + (1.0 - lam) * cross_entropy_label_smooth(logits, label_b, smoothing)
            pen = (penalty_fn(params, ts.masks, rho_mult=ts.rho_mult, step=ts.step) if penalty_fn is not None
                   else torch.zeros((), device=logits.device))
            loss = ce + pen
            grad_list = torch.autograd.grad(loss, leaves)
        flat_state = {k: v.detach() for k, v in flatten_tree(new_state).items()}
        if group is not None and bn_group is None:
            flat_state = dict(zip(flat_state, collectives.broadcast_first(list(flat_state.values()), group)))
        new_state = unflatten_tree(flat_state)
        if sharded_update is not None:
            new_params, new_opt_state, grad_norm = sharded_update(
                unflatten_tree(dict(zip(keys, grad_list))), ts.opt_state, ts.params)
        else:
            grad_list = collectives.all_reduce_mean(list(grad_list), group)
            updates, new_opt_state = optimizer.update(unflatten_tree(dict(zip(keys, grad_list))), ts.opt_state,
                                                      ts.params)
            new_params = apply_updates(ts.params, updates)
            grad_norm = global_norm(list(grad_list))
        logits = logits.detach()
        n = float(logits.shape[0])
        metrics = {
            "loss": loss.detach(),
            "ce": ce.detach(),
            "penalty": pen.detach(),
            "top1": topk_correct(logits, labels, ks=(1,))["top1"] / n,
            "lr": lr_fn(ts.step),
            "grad_norm": grad_norm,
            "finite": torch.isfinite(loss.detach()).float(),
        }
        if group is not None:
            metrics = dict(zip(metrics, collectives.all_reduce_mean(list(metrics.values()), group)))
        new_ts = ts.replace(
            step=ts.step + 1,
            params=new_params,
            state=new_state,
            opt_state=new_opt_state,
            ema_params=ema_update(cfg.ema, ts.ema_params, new_params, ts.step) if cfg.ema.enable else None,
            ema_state=ema_update(cfg.ema, ts.ema_state, new_state, ts.step) if cfg.ema.enable else None,
        )
        return new_ts, metrics

    return step_fn


def make_eval_step(net: Network, cfg: Config, *, group=None):
    """Returns eval_fn(params, state, batch, masks) -> summed counts
    {'top1', 'top5', 'n', 'loss_sum'} as 0-dim device tensors, summed over
    ``group``'s ranks when one is given. Eval always normalizes with the
    exact BN expression and the stock conv lowering, whatever
    ``train.bn_mode``/``train.conv1x1_dot`` say; padded rows carry label -1
    and are left out of every count."""
    _check_bn_mode(cfg)
    compute_dtype = _dtype(cfg.train.compute_dtype)
    prep_input = _input_normalizer(cfg)

    @torch.no_grad()
    def eval_fn(params, state, batch, masks):
        imasks = {int(k): v for k, v in masks.items()} or None
        logits = net.apply(params, state, prep_input(batch["image"]), train=False, compute_dtype=compute_dtype,
                           masks=imasks)
        labels = batch["label"].long()
        valid = (labels >= 0).float()
        safe = torch.clamp_min(labels, 0)
        k = min(5, logits.shape[-1])
        pred = torch.topk(logits, k, dim=-1).indices
        hit = (pred == safe[:, None]) & (valid[:, None] > 0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[:, None])[:, 0]
        counts = {"top1": hit[:, :1].sum().float(), "top5": hit.sum().float(), "n": valid.sum(),
                  "loss_sum": (nll * valid).sum()}
        return dict(zip(counts, collectives.all_reduce_sum(list(counts.values()), group)))

    return eval_fn
