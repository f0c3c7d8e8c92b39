"""Traffic kind ``train``: the training step, run back to back on the card for the window.

A mix of this kind (``benchmark/traffic/<mix>.json``) gives ``batch`` (images a step on this
card), ``pool_batches`` (distinct batches drawn at set-up and cycled through: no decode, no
augmentation) and ``trace_steps`` (the steps of a traced run's window).

Set-up builds, as ``cli/train.py`` builds it for a world of one, the program's step
(``parallel/dp.py`` ``make_dp_train_step`` over ``train/steps.py``) with the configuration's
optimizer, LR schedule and EMA, and one ``TrainState`` from the drawn weights, running statistics
and weights' shadow (``inputs.ema_weights``); it drives that
state through the check's first steps (``CHECK_STEPS``), whose results it keeps, and hands the
same step and state on to the window. The reference follows those first steps after the window.
"""

from __future__ import annotations

import time

import torch

from .. import inputs
from ..frozen import costs
from ..reference import compare, lowp, nets
from ..reference import train as ref_train

CHECK_STEPS = 3


def port_config(cfg: dict, batch: int):
    """The program's Config for a configuration file: its sections as the program names them."""
    from yet_another_mobilenet_series_tpu_torch.config import config_from_dict

    keep = {"model": cfg["model"], "optim": cfg["optim"], "schedule": cfg["schedule"], "ema": cfg["ema"],
            "dist": cfg["dist"], "data": cfg["data"],
            "train": dict(cfg["train"], batch_size=batch)}
    return config_from_dict(keep)


class Runner:
    def __init__(self, cell, seed: int, device: torch.device, spans):
        self.cell, self.seed, self.device, self.spans = cell, seed, device, spans
        self.cfg = cell.config
        self.batch = int(cell.traffic["batch"])
        self.size = int(self.cfg["data"]["image_size"])
        self.arch = nets.from_config(self.cfg["model"])
        self.recipe = ref_train.Recipe.from_config(self.cfg, self.batch)
        self.step_seed = inputs.sub_seed(seed, "step")

    # -- inputs --------------------------------------------------------------------------

    def batch_at(self, i: int, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        x = inputs.images(self.seed, f"train-images-{i}", self.batch, self.size, self.device, dtype)
        y = inputs.labels(self.seed, f"train-labels-{i}", self.batch, self.arch.num_classes, self.device)
        return x, y

    # -- the program ---------------------------------------------------------------------

    def setup(self) -> None:
        from yet_another_mobilenet_series_tpu_torch.models import get_model
        from yet_another_mobilenet_series_tpu_torch.parallel import dp, mesh
        from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps
        from yet_another_mobilenet_series_tpu_torch.utils.device import set_tf32

        cfg = port_config(self.cfg, self.batch)
        self.port_cfg = cfg
        set_tf32(cfg.train.compute_dtype)
        net = get_model(cfg.model, image_size=self.size)
        per_epoch = max(cfg.data.num_train_examples // self.batch, 1)
        lr_fn = schedules.make_lr_schedule(cfg.schedule, self.batch, per_epoch, cfg.train.epochs)
        params, state = inputs.weights(self.arch, self.seed, self.device)
        self.p0 = {k: v.cpu() for k, v in params.items()}
        self.s0 = {k: v.cpu() for k, v in state.items()}
        ema = inputs.ema_weights(params, self.seed, self.device)
        self.e0 = {k: v.cpu() for k, v in ema.items()}
        tree_p, tree_s = inputs.nest(params), inputs.nest(state)
        optimizer = optim.make_optimizer(cfg.optim, lr_fn, tree_p)
        opt_state = optimizer.init(tree_p)
        start = self.recipe.start_step
        opt_state["count"].fill_(start)
        ts = steps.TrainState(
            step=torch.full((), start, dtype=torch.int32, device=self.device), params=tree_p, state=tree_s,
            opt_state=opt_state, ema_params=inputs.nest(ema),
            ema_state=inputs.nest({k: v.clone() for k, v in state.items()}), masks={}, rho_mult=None)
        self.step = dp.make_dp_train_step(net, cfg, optimizer, lr_fn, mesh.make_mesh(self.device))
        self.gen = torch.Generator(device=self.device).manual_seed(self.step_seed)
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.train.compute_dtype]
        self.pool = [self.batch_at(i, dtype) for i in range(int(self.cell.traffic["pool_batches"]))]
        losses = []
        for i in range(CHECK_STEPS):
            ts, m = self.step(ts, {"image": self.pool[i][0], "label": self.pool[i][1]}, self.gen)
            losses.append(m["loss"])
            if i == 0:
                first = {k: v.detach().to("cpu", torch.float64) for k, v in
                         inputs.flatten({"nu": ts.opt_state["nu"], "trace": ts.opt_state["trace"]}).items()}
        self.prog = {"losses": [float(x) for x in losses], "first": first,
                     "params": {k: v.cpu() for k, v in inputs.flatten(ts.params).items()},
                     "state": {k: v.cpu() for k, v in inputs.flatten(ts.state).items()},
                     "ema": {k: v.cpu() for k, v in inputs.flatten(ts.ema_params).items()},
                     "ema_state": {k: v.cpu() for k, v in inputs.flatten(ts.ema_state).items()}}
        self.ts = ts
        self.next_batch = CHECK_STEPS
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_steps(self, until) -> tuple[int, list]:
        n, losses = 0, []
        while not until(n):
            x, y = self.pool[self.next_batch % len(self.pool)]
            self.next_batch += 1
            with self.spans.span("bench/train.step"):
                self.ts, m = self.step(self.ts, {"image": x, "label": y}, self.gen)
            losses.append(m["loss"])
            n += 1
        return n, losses

    def window(self, seconds: float, tracer) -> dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        tracer.start()
        t0 = time.perf_counter()
        if tracer.on:
            trace_steps = int(self.cell.traffic["trace_steps"])
            n, losses = self._run_steps(lambda n: n >= trace_steps)
        else:
            n, losses = self._run_steps(lambda n: time.perf_counter() - t0 >= seconds)
        tracer.stop()
        wall = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses)).tolist() if losses else []
        out = {"attempted": n, "failed": finite.count(False), "steps": n, "images": n * self.batch,
               "window_s": wall, "train_images_per_s": n * self.batch / wall}
        if cuda:
            out["train_peak_gb"] = torch.cuda.max_memory_allocated(self.device) / 1e9
            self.peak = max(self.setup_peak, torch.cuda.max_memory_allocated(self.device))
        return out

    def release(self) -> int:
        """Free the program's state; the process's peak memory so far."""
        del self.ts, self.step, self.pool
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        return self.peak

    def layer_counters(self) -> dict:
        return {"macs_per_image": costs.forward_macs(self.arch, self.size), "mfu_factor": 6,
                "precision": self.port_cfg.train.compute_dtype}

    # -- the check -----------------------------------------------------------------------

    def program_readings(self) -> dict:
        """The program's losses, its first gradient as the optimizer got it (worked out from
        the RMSProp state after one step: nu = d + (1 - d) g^2 from 1, and the momentum trace
        -lr g / sqrt(nu + eps) from 0), and the changes over the steps."""
        r = self.recipe
        lr = r.lr(r.start_step)
        grad = {}
        for k in self.p0:
            nu, trace = self.prog["first"][f"nu/{k}"], self.prog["first"][f"trace/{k}"]
            grad[k] = compare.norm(-trace * torch.sqrt(nu + r.rmsprop_eps) / lr)
        return {"losses": self.prog["losses"], "grad": grad,
                "change": compare.change_norms(self.prog["params"], self.p0),
                "bn_stats": compare.change_norms(self.prog["state"], self.s0),
                "ema": compare.change_norms(self.prog["ema"], self.e0),
                "ema_stats": compare.change_norms(self.prog["ema_state"], self.s0)}

    def reference_readings(self, ops: nets.Ops = nets.PLAIN, rows: int | None = None) -> dict:
        plain = ops is nets.PLAIN and rows is None
        if plain and getattr(self, "_plain", None) is not None:
            return self._plain
        params = {k: v.to(self.device) for k, v in self.p0.items()}
        state = {k: v.to(self.device) for k, v in self.s0.items()}
        ema = {k: v.to(self.device) for k, v in self.e0.items()}
        batches = [self.batch_at(i, torch.float32) for i in range(CHECK_STEPS)]
        # the program's images are bf16: the reference reads the same values
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.cfg["train"]["compute_dtype"]]
        batches = [(x.to(dtype).float(), y) for x, y in batches]
        with lowp.tf32(False):
            t = ref_train.run(self.arch, self.recipe, params, state, ema, batches, self.step_seed, ops=ops, rows=rows)
        out = {"losses": t.losses, "grad": t.grad_norms, "change": compare.change_norms(t.params, self.p0),
               "bn_stats": compare.change_norms(t.state, self.s0), "ema": compare.change_norms(t.ema, self.e0),
               "ema_stats": compare.change_norms(t.ema_state, self.s0)}
        if plain:
            self._plain = out
        return out

    def check(self) -> dict[str, dict]:
        return compare.train_numbers(self.program_readings(), self.reference_readings())

    def control(self) -> dict[str, dict]:
        """The reference in the program's place, in FP8 (the precision below bf16)."""
        ref = self.reference_readings()
        return compare.train_numbers(self.reference_readings(ops=lowp.FP8), ref)

    def faults(self) -> dict[str, dict[str, dict]]:
        """The faults a training cell can have, planted in the reference put in the program's
        place: half the batch left out (the mean over the rest); a state left unchanged reads 1
        on ``change`` by construction and needs no run."""
        ref = self.reference_readings()
        half = compare.train_numbers(self.reference_readings(rows=self.batch // 2), ref)
        return {"half_batch": half}

    def witness(self) -> tuple[dict[str, dict], dict]:
        """The reference itself in the program's precision (bfloat16 convolutions and dense
        layers: ``lowp.BF16``) against the float32 reference: the gaps that bfloat16's rounding
        alone makes. Also each side's per-leaf norms, program, reference and witness."""
        ref = self.reference_readings()
        bf16 = self.reference_readings(ops=lowp.BF16)
        leaves = {side: {k: v for k, v in r.items() if k != "losses"}
                  for side, r in (("program", self.program_readings()), ("reference", ref), ("bf16", bf16))}
        return compare.train_numbers(bf16, ref), leaves

