#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``yet_another_mobilenet_series_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package, and it fails
(exit code other than 0, no result line) on a machine without CUDA or when
the port is not beside it.

K1's launches are counted by the kernel itself: one atomic a launch into a
counter on the card (``ops/fused_depthwise.py`` ``device_launches``), read
around each gated run (``_k1_on_card``) and held exactly to the graphs'
accounting (warm runs + replays x captured launches) or to the wrapper's
count of eager launches (``_k1_card_gate``). Where a phase prints kernel
shares or device time, ``torch.profiler`` still records the window, and its
count of K1's records is printed beside the card's, never above it.

The script must end within the contract's 1200 s. It prints a ``time:``
line after each group of phases (its seconds and the seconds since the
start) and, under it, ``time:   <phase> <step> <seconds> s`` lines for the
steps of the long phases. Fixed costs (new processes, CUDA contexts,
cuDNN's first calls on new shapes) are most of its time, so work that needs
no card runs beside work that does: the builds of phase 2 and 13 (a) and
phase 16's gate start first and run beside phases 7 (a), 8 (a) and 17 (a), which
need no kernel of the port; the benches of phase 9 and phase 12 (a)'s run
without a group run in this process; phase 9's ``--zoo`` and ``--fleet``
arms run as processes of their own beside phases 12 (e) and 11 (a)-(c),
whose checks are exact (bit for bit, counts), which a busy card cannot
move; torchrun's run beside phase 12 (a)'s other run and (c); phase 10
(b)'s server starts beside (a); phase 15 (d)'s dry run beside phase 14's
untimed (c) and (e). In order it:

1. prints the card's name and power limit (``nvidia-smi``) and the torch,
   CUDA and ``nvcc`` versions;
2. builds every kernel of the serving path from the sources in the checkout
   (one ``nvcc`` per source, all started together) and prints the time and
   what ``ptxas`` reports;
3. holds each kernel against its plain PyTorch version on the card: the 15
   depthwise stages of MobileNetV3-Large at 224 at each serving bucket
   (batch 1, 8 and 32, whose plans tile differently) and the 11 stages of
   MobileNetV3-Small 1.0 at 224 at batch 32, in float32 (atol = rtol =
   1e-5, TF32 off) and bfloat16 (BF16_ATOL/BF16_RTOL), the grid of
   the JAX package's Pallas tests, AtomNAS-style channel slices of a wider
   tensor on the scalar and the vector path, and a tiny multi-branch net's
   folded logits against the port's CPU forward (SLICE_ATOL/SLICE_RTOL).
   Then, per stage at batch 32 and in both types, it times the kernel warm,
   back to back (``cuda_time_ms``: the host's pace where a launch costs the
   host more than the device), warm on the device alone (``device_ms``: the
   stream idles first while the host enqueues the launches, as a CUDA graph
   would replay them) and cold (a 128 MB buffer written before each launch,
   so L2 holds none of its inputs), and, as a diagnostic, cold with a clean
   L2 (the flush read back from another buffer, so the launch pays no
   write-back of dirty lines); then F.conv2d(groups=C, bias) the same three
   ways and the plain version; prints the bound and the cold share of it;
   and the host microseconds per call of the wrapper and of F.conv2d; then
   the same times at MobileNetV3-Small's 11 stages;
4. serves MobileNetV3-Large 1.0 at 224 in float32 with seeded weights,
   three loads through the port's entry point, ``cli/serve.py``'s
   ``run(cfg, device)``, which captures every graph at warmup: (a) the
   shipped ``apps/serve_mobilenet_v3.yml`` as shipped (buckets 1/8/32, the
   fused-K ladder [2, 4], overlapped staging), (b) the same with
   ``serve.ring.enable=true``, (c) the same with ``serve.quant.wire=uint8``;
   each 256 single-image requests from 8 closed-loop clients, the counts
   set to 0 just before and read just after. Gates: every request
   completes, 0 shed, 0 rejected; the graphs are the ladder's, each
   captured once; every dispatch is a graph replay; each graph holds 15 K1
   launches per forward it runs and K1 launched nothing outside warm runs
   and captures. Then, per load, an engine built the same way
   (``engine_kwargs``, the batcher of ``_make_batcher``) takes what single
   images do not make, under ``torch.profiler``: a bulk client's requests
   of 40-128 rows to ``engine.predict`` (the fused ladder) beside a burst
   client's 128 images at once, three times (ring windows). Gates: every
   dispatch a replay, fused dispatches (and ring windows) ran, the card's
   own count of K1 launches equals replays x captured launches, and the
   logits match the port's CPU forward within SLICE_ATOL/SLICE_RTOL;
5. holds on the card, bit for bit: graph replay against the eager forward
   per bucket, fused K=2 and K=4 against per-chunk, ring fills 1..4
   against the per-batch path at bucket 32, overlap on against off, two
   unsynced in-flight dispatches of one key against their own eager
   results, and the shift-free u8 wire against the f32 wire fed
   ``normalize_reference`` pixels; then an int8 bundle against its own
   dequantized f32 forward within the int8 gate (top-1 agreement);
6. times, per bucket, the eager forward against the graph replay (host
   enqueue, device time back to back and alone), the serving dispatch's
   host cost, the fused K=4 graph per chunk and the ring R=4 graph per
   slot, graph memory, a new thread's first forward, and breaks five
   batch-32 replays down by kernel with ``torch.profiler``, K1's launches
   on the card's counter 5 x 15;
7. trains MobileNetV3-Large 1.0 at 224 (``apps/mobilenet_v3_large.yml``,
   the port's training path; (a) first of all, beside the builds): (a) one f32 step at batch 8 on the card and on
   the port's CPU path from one state and batch, TF32 off, loss, grad norm
   and updated params held at TRAIN_*_TOL; (b) ``cli/train.py``'s
   ``run()`` (here ``train()``, which also returns the state) on the
   shipped config as shipped (bf16, batch TRAIN_BATCH, TF RMSProp, EMA)
   with the fake dataset, TRAIN_STEPS steps and the EMA eval, under
   ``torch.cuda.set_sync_debug_mode("warn")``: gates every step finite, the
   step counter equal to the steps taken, no host sync inside a step
   between log points, the run on cuda, and no K1 launch (the training
   forward has no folded stage); (c) OVERFIT_STEPS steps on one repeated
   batch of OVERFIT_BATCH at a constant LR, the loss below OVERFIT_FACTOR
   of its first value; (d) the trained EMA weights exported
   (``export_bundle``) and served (``InferenceEngine``), logits against
   ``Network.apply(train=False)`` of the same weights within FOLD_ATOL, and
   15 K1 launches per forward, in the graph's capture and on the card's
   counter over SERVED_FORWARDS forwards; (e) ms per step,
   synchronized, and images/s in bf16 and f32, peak memory, and five bf16
   steps under ``torch.profiler``: device-busy share, top kernels, the
   optimizer update's share (its ``multi_tensor_apply`` kernels, and the
   update timed alone);
8. runs the AtomNAS search ((a) beside the builds, after 7 (a);
   ``apps/atomnas_a_search.yml``: atomnas_supernet
   1.0 at 224, relu6, bf16, TF RMSProp, EMA, target 258M MACs; one card, the
   cuts of the SEARCH_* constants): (a) one f32 search step, with the
   penalty, and one prune event on the card and on the port's CPU path from
   one state: loss and penalty at TRAIN_LOSS_TOL, the masks equal, grad norm
   and params at the larger of TRAIN_*_TOL and SEARCH_SPREAD_FACTOR times
   the card's own spread between cuDNN and its native convolutions (the
   supernet's first step is ill-conditioned in float32); (b) the search through
   ``cli/train.py``'s ``train()`` under ``set_sync_debug_mode("warn")``:
   gates every step finite, atoms dead and a rematerialization mid-run that
   rebuilt the trainer and freed the supernet's memory, searched_arch.json
   below the supernet's MACs, no host sync inside a step or a prune event,
   no K1 launch; then the supernet's and the searched net's step timed
   alone; (c) the masked supernet's eval forward against the
   rematerialized one on the card at the f32 bar, and a dead-mask export
   whose spec is the rematerialized one; (d) the searched EMA weights
   exported and served through ``cli/serve.py``'s ``run()`` (buckets
   1/8/32, f32), K1 one launch per surviving branch per forward in the
   graphs and on the card's counter, logits against
   ``Network.apply`` within
   FOLD_ATOL; (e) K1 against its plain version at every branch of the
   supernet and of the searched net as channel slices in place (batches 1
   and 32, f32 and bf16), then timed beside F.conv2d at the searched net's
   branches; (f) a few steps of ``apps/retrain_searched.yml`` on
   searched_arch.json;
9. runs the port's benches (``yet_another_mobilenet_series_tpu_torch/bench``)
   (each one's ``main`` in this process, as ``python -m`` runs it) at short
   lengths, each line parsed and gated on
   ``cuda``, the card's name, power limit and versions: (a) the training
   bench, a few bf16 steps at TRAIN_BATCH, MFU in (0, 1.05]; (b)
   ``trace_ops`` over its profiled window; (c) the serve bench's arms with
   few iterations and one open-loop round (bf16 ``parity_ok``, K1 counted
   at 15 a forward, every request resolved); (d) the latency table of
   ``apps/atomnas_a_search.yml``'s supernet measured on the card, then a
   few steps of phase 8's search config with ``prune.cost=latency_table``
   on it through ``cli/train.py``: an event fires, every step finite, no
   host sync inside a step, and the cost vectors are not the FLOPs ones;
   (e) the serve bench's ``--zoo`` arm (a fleet of MobileNetV3-Small int8 and
   MobileNetV3-Large f32 replicas: escalations, answers bitwise one of the
   references, no misroute, the cascade's FLOPs per request below
   big-only's) and its ``--fleet`` arm (hedging, kill -9, the autoscaler),
   cut short, every request resolved: each through ``python -m``, beside
   phases 12 (e) and 11 (a)-(c), their lines printed there;
10. serves beyond one model and one process, MobileNetV3-Small 1.0 (int8,
   ``small``) and MobileNetV3-Large 1.0 (f32, ``big``) at 224 with seeded
   weights, each bundle stamped with its name and digest: (a) one zoo engine
   on the card built as ``cli/serve.py`` builds it, the counts at 0 just
   before its traffic and read just after: every dispatch a replay, 11 and 15
   K1 launches per forward in every graph and none outside warm runs and
   captures, logits against each tenant's CPU forward (SLICE_ATOL/SLICE_RTOL),
   the int8 tenant against its dequantized forward (phase 5's gate), the graph
   paths bitwise equal to single-bundle engines on the card, and K1 counted by
   the card's counter (11 and 15 a forward), then behind the port's fault
   injector (F3: its first dispatches failing, retried) each request
   answered by the tenant it named, bit for bit; (b) ``cli.serve
   --listen`` in a subprocess serving the zoo: loopback HTTP answers with and
   without ``X-Model`` bitwise equal to (a)'s engine at bucket 1, an unknown
   model a typed 400, ``/healthz``, ``/metrics``, ``/varz`` with the compile
   report's ``_m<name>`` keys, a ``/profile`` window holding K1 records, and a
   SIGTERM under load that resolves every request and drains clean; (c)
   ``cli.fleet`` with two replicas placed ``small;big`` and the cascade at the
   median margin of a seeded image set: escalations > 0, every answer bitwise
   one of the two references, dispatched FLOPs per request (the replicas'
   ``/varz``) below a big-only round's, kill -9 of the big replica under load
   with failed = unresolved = 0 and a restart, and no context on the card
   held by the supervisor (``nvidia-smi``'s compute apps); the fleet runs
   with ``obs.trace=true``, and after its exit ``python -m ...obs.trace_merge``
   joins the router's and both replicas' traces (three lanes, each with
   events) and ``python -m ...obs.report --fleet`` renders its fleet view;
11. runs the life of a training run on MobileNetV2 1.0 at 224, in this
   process after phase 10: (a) a torchvision-layout state_dict from seeded
   tensors, saved as .pth, evaluated by ``cli/train.py`` with
   ``apps/eval_mobilenet_v2.yml`` and ``train.torch_pretrained`` on the card
   and on the CPU: the eval images are the same bits on both, loss
   (TRAIN_LOSS_TOL) and top-1 agree, the run's logits equal the imported
   tree's ``Network.apply`` (SLICE_ATOL/SLICE_RTOL, TF32 off); (b)
   ``apps/mobilenet_v2.yml`` warm-started from it (LIFE_CUTS: batch 64, 3
   steps an epoch, 4 epochs, a checkpoint every epoch), twice uninterrupted,
   then killed by ``train.faults.kill_at_step`` (the SIGTERM handler
   checkpoints synchronously, the run returns ``preempted``,
   ``preempt_marker.json`` is written), then resumed to the end with the
   marker consumed, under ``torch.use_deterministic_algorithms``: the final
   state bit for bit equal to the uninterrupted run's, or within
   LIFE_SPREAD_FACTOR times the two uninterrupted runs' spread, and
   ``python -m ...obs.report`` renders the resumed run's log dir (its
   training books and its step's cost); (c) the
   killed run's newest step truncated in one copy and one weight's bit
   flipped in another: each resume falls back one step
   (``ckpt.restore_fallbacks`` 1, ``ckpt.integrity_failures`` 1 for the
   flip) and ends where the uninterrupted run does; (d) ``cli/serve.py``'s
   ``run()`` with ``serve.export_from`` on the resumed run's checkpoints
   (buckets 1/8/32, f32): every dispatch a replay, K1 17 launches a forward
   in the graphs and on the card's counter, logits against the
   EMA ``Network.apply`` within FOLD_ATOL; (e) K1 against its plain version
   at MobileNetV2's 17 stages (batches 1/8/32, f32 and bf16) and the stage
   times of phase 3; (f) a checkpoint's save (enqueue, wait), restore and
   bytes, the step time with and without a save in flight, and an eval
   pass with the eval noise made three ways; K1's wrapper count is read
   around every training and eval-only run of the phase;
12. trains data parallel and grouped (``parallel/``, MobileNetV3-Large 1.0
   at 224, bf16, batch 256 unless said): (a) ``apps/mobilenet_v3_large.yml``
   for DP_STEPS steps through ``cli/train.py``'s ``main`` in this process
   without a process group and through ``python -m torch.distributed.run --standalone
   --nproc_per_node 1`` with ``dist.multihost=true`` (NCCL, a world of 1):
   the final checkpoints bit for bit equal, ms per step both ways; (b) in
   this process's NCCL world of 1, ``dist.shard_optimizer=true`` (ZeRO)
   against the replicated update, both clipping, within ZERO_TOL; (c) two
   ranks on the one card over an explicit gloo group of CUDA tensors,
   calling ``parallel/dp.py`` directly: one f32 SyncBN step at global batch
   GLOO_BATCH against one process at GLOO_RTOL/GLOO_ATOL, the replica check
   0.0, then a one-ulp drift planted on rank 1, which it reads; (d) the
   grouped step, K=GROUP_K steps as one CUDA graph, on MobileNetV3-Large and
   on ``apps/atomnas_a_search.yml``'s supernet with the prune event firing
   inside the group: in the NCCL world of 1 under deterministic algorithms,
   two groups bit for bit equal to K eager steps each and 0 host syncs in a
   replay; in one process, ms per step eager against grouped, kernels per
   replay and peak memory, and the same times for phase 8's searched net;
   (e) ``cli/train.py`` in the NCCL world of 1 with
   ``train.steps_per_dispatch=4`` and ``train.param_checksum_every=4``: every
   replica check 0.0, killed at the second group and resumed, bit for bit
   the uninterrupted run;
13. trains from JPEGs on MobileNetV2 1.0 at 224 (``apps/mobilenet_v2.yml``,
   bf16, batch REAL_BATCH; the real-data input path, ``data/``): (a) builds
   (a compile started with the run's other builds) and loads
   the host library (``ops/host_build.py``: g++, the copied native loader,
   libjpeg or, where the host has none, nvJPEG through libjpeg's API) and
   prints its time, g++'s version, the JPEG library, the CPU and its cores,
   the decodes held to the committed libjpeg ones (NVJPEG_TOL); (b) writes,
   with the port's encoder, an image folder of REAL_CLASSES classes (train
   and val) and the same images as TFRecord shards; (c) times the loader
   alone at one thread and one a core, f32 and uint8, and beside a card
   kept busy with the host idle (the card's share), and the TFRecord train
   stream with its interleave and record buffer (the default) and with
   ``data.deterministic_input``: images/s, the mean distinct labels a batch
   of its first epoch, and the seconds of the record-order simulation, here
   and for one host's ImageNet epoch (ORDER_SECONDS_BAR); (d) ``cli/train.py``'s
   ``run()`` from the folder (prefetch thread, uint8 transfer, a profiler
   window over steps 8-11), gating every step finite, eval_n ==
   REAL_VAL_IMAGES, no decode failure and the window's trace, then the same
   run from the fake stream: ms per step both ways, the device's busy share,
   whether the host paces the step; (e) the same eval from the TFRecord
   shards, top-1 and loss equal to (d)'s; (f) each loader stream (the
   TFRecord one buffered) restarted mid-epoch and just before the epoch
   boundary, bit for bit the uninterrupted one; (g) the checkpoint exported
   and served on the uint8 wire through ``cli/serve.py``'s engine, the val
   crops' logits within FOLD_ATOL of the CPU folded forward, K1 17 launches
   a forward in the graphs and on the card's counter;
14. runs the training-side tools on the card (``bench/``, the tuning file):
   (a) ``bn_bench`` on MobileNetV3-Large 1.0 at 224, bf16, batch 256, six
   of its variants (every family) and the dispatch probe: every variant
   timed with a finite loss, the probe a CUDA graph; (b) ``tuning_decide``
   on its artifact into a temporary tuning file that ``train/tuning.py``
   accepts; (c) ``cli/train.py``'s ``main`` with ``train.tuning_file`` on
   it (batch 64, 8 steps): its provenance lines logged, the step config
   that ran the tuned one, the grouped step a CUDA graph when the file sets
   ``steps_per_dispatch``, no K1 launch; (d) ``input_bench`` on phase 13's
   folder and TFRecord shards; (e) ``train_chaos`` (its rounds are
   ``cli.train`` subprocesses): corrupt records skipped, a NaN step rolled
   back, a SIGTERM checkpointed, the resume from its step to the end. (a)
   and (d) run the benches' ``main`` in this process, whose cuDNN choices
   and host library are made by then;
15. serves and trains across devices (``parallel/mesh.py``'s serving mesh,
   the serve bench's overload arm, ``graft_entry.py``): (b) MobileNetV3-Large
   1.0 at 224, f32, buckets 8/32 on a single-device engine, a mesh of 1 on
   the card (bit for bit against it) and a mesh of two lanes on the one
   card, built from an explicit device list (two replicas of one card, not
   two cards; SLICE_RTOL/SLICE_ATOL against it), their QPS at bucket 32 in
   interleaved rounds, and ``cli/serve.py``'s ``run()`` with
   ``serve.data_parallel=true``, K1's launches as each lane's captured
   launches x replays; (c) ``serve_bench --overload`` on MobileNetV3-Large
   (storms of OVERLOAD_STORM_S, OVERLOAD_GRAY_REQUESTS gray requests: cuts,
   each logged; the storm at OVERLOAD_MULTIPLE x the capacity): availability higher with brownout on, the ladder back at
   L0, nothing unresolved, the straggler soft-ejected; (d)
   ``dryrun_multichip(1)`` over NCCL finite (started beside phase 14 (c)
   and (e)), and its RuntimeError for more ranks than cards. F9's check (4:4:4 through libjpeg's conversion) is in
   phase 13 (a);
16. runs the port's static analyzer on this machine (``analysis/``, no
   kernel launched): (a) its gate as tier-1 runs it, in a process of its
   own started with the run (``analysis/scope.py``:
   the package under every rule; ``bench/``, the two data tools and this
   script under the curated subset), its finding count and seconds printed,
   any finding a failure; (b) every private torch name the gate lets
   through by name or by a suppression resolves on this machine's torch;
17. runs the zoo's remaining families (MobileNetV1, MNASNet-A1,
   EfficientNet-B0 and -Lite0 at 1.0, the AtomNAS-C+SE supernet at 1.1 from
   ``apps/atomnas_c_se.yml``, all at 224 with seeded weights): (a) one f32
   step of each on the card and on the port's CPU path (beside the builds,
   after 8 (a)), at TRAIN_*_TOL (the supernet under 8 (a)'s spread rule);
   (b) each exported and served by engines on the card at buckets 1 and 32,
   f32 and bf16, every key a CUDA graph: K1 13/16/16/16/51 launches a
   forward, the card's own counter equal to the accounting, logits against
   the CPU forward (SLICE_ATOL/SLICE_RTOL in f32, FAMILY_BF16_ATOL in bf16);
   (c) K1 against its plain version at every depthwise branch of the five
   nets as channel slices in place (C+SE's 11/11/10 off the 16-byte vector
   on the scalar path), batches 1 and 32, f32 and bf16; (d) K1 timed at
   each net's stages at batch 32 as in phase 3; (e) the C+SE prune event on
   the card (masks equal to the CPU's), the rematerialization on the card
   and the pruned net served through K1 against the CPU's folded forward
   within FOLD_ATOL; (f) RandAugment on the card against the CPU op by op
   and for the recipe's batches (tests/test_torch_port_randaugment.py's
   bar), then timed; (g) ``apps/efficientnet_b0.yml`` (RandAugment 2/9,
   RMSProp, EMA, drop_connect 0.2) through ``cli/train.py`` on phase 13's
   TFRecord shards, RECIPE_STEPS steps at RECIPE_BATCH: every step finite,
   no host sync inside a step;
18. prints the ``kernels`` JSON line, the card line again, and as the last
   line ``{"ok": true, "device": {...}}``.

Details too long for the end of the output go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait

from yet_another_mobilenet_series_tpu_torch.utils.benchkit import (
    card_line, cold_time_ms, cuda_time_ms, device_time_ms, host_us_per_call)

REPO = os.path.dirname(os.path.abspath(__file__))
APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "serve_mobilenet_v3.yml")

# the CUDA sources of the path (csrc/<name>.cu), one nvcc each, all at once
KERNEL_SOURCES = ("fused_depthwise",)
# float32 kernel vs plain version (tests/test_pallas.py's bar), TF32 off
F32_TOL = 1e-5
# bfloat16: kernel and plain version both accumulate in float32 and round
# the result once to bfloat16 (8 significant bits), so they differ by at
# most one bfloat16 ulp where their float32 sums fall on opposite sides of a
# rounding boundary: 2**-7 relative at worst. The largest error measured on
# the card is printed beside this bar.
BF16_ATOL = 1e-2
BF16_RTOL = 2.0 ** -7
# the served logits on the card vs the port's CPU forward of the same
# bundle, both float32 (TF32 off): the repository's float32 forward parity
# bar (rtol 1e-4, atol 1e-5)
SLICE_ATOL = 1e-5
SLICE_RTOL = 1e-4

# published memory bandwidth and float32 (non-tensor-core) rate of the
# H100 variants (NVIDIA data sheets); the SXM part is the default
_BW = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
_F32 = {"PCIe": 51e12, "NVL": 60e12, "SXM": 67e12}

# the serving buckets of apps/serve_mobilenet_v3.yml
BUCKETS = (1, 8, 32)
IMAGE_SIZE = 224
SERVE_REQUESTS = 256
SERVE_CLIENTS = 8
# beside the closed-loop clients of each load: a bulk client sending
# requests of more than 32 rows to engine.predict (the fused ladder: 40 rows
# = K=2 with a padded tail, 64 = K=2, 100 = K=2 + K=1 + a bucket-8 tail, 128
# = K=4), and a burst client submitting BURST_IMAGES single images at once
# (a queue deep enough for ring windows), BURSTS times
BULK_ROWS = (40, 64, 100, 128)
BULK_REQUESTS = 8
BURST_IMAGES = 128
BURSTS = 3
# rows of each load held against the port's CPU forward (besides a bulk
# request and the closed-loop image)
CPU_ROWS = 8
# phase 4's loads: the shipped config as shipped, then the ring, then the
# uint8 wire (raw pixels, denormalized with data.mean/std on the card)
LOADS = (("shipped", []), ("ring", ["serve.ring.enable=true"]), ("uint8", ["serve.quant.wire=uint8"]))
# phase 7, training: the shipped config, the fake dataset at 224
TRAIN_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "mobilenet_v3_large.yml")
TRAIN_BATCH = 512  # apps/mobilenet_v3_large.yml's train.batch_size
TRAIN_STEPS = 20
TRAIN_LOG_EVERY = 10
TRAIN_CHECK_BATCH = 8
# one f32 step on the card against the port's CPU path (TF32 off): loss and
# grad norm relative, updated params as |diff| / (1 + |p|). Measured once on
# an H100 80GB HBM3 at 700 W: loss 0 (equal to 8 digits), grad norm 3.1e-5,
# params 1.7e-7 (BN state 1.2e-7, nu 1.3e-7)
TRAIN_LOSS_TOL = 1e-5
TRAIN_NORM_TOL = 1e-4
TRAIN_PARAM_TOL = 1e-6
OVERFIT_STEPS = 30
OVERFIT_BATCH = 32
OVERFIT_LR = 0.02
OVERFIT_FACTOR = 0.7
TIMING_STEPS = 10
PROFILED_STEPS = 5
# phase 8, the AtomNAS search: apps/atomnas_a_search.yml at full width
# (atomnas_supernet 1.0 at 224), cut to one card and a short run
SEARCH_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "atomnas_a_search.yml")
RETRAIN_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "retrain_searched.yml")
SEARCH_BATCH = 256  # the config's 2048 is spread over 16 chips
SEARCH_STEPS_PER_EPOCH = 8
SEARCH_EPOCHS = 3
SEARCH_LOG_EVERY = 4
SEARCH_EVAL_IMAGES = 512
# an event every 2 steps (the config's 500 would fire none in this run) and a
# rematerialization at every epoch boundary, so the trainer is rebuilt
# mid-run and trains on the shrunk network
SEARCH_MASK_INTERVAL = 2
SEARCH_REMAT_EPOCHS = 1
# gammas start at 1, so |gamma| < 1.0 kills each atom whose gamma the first
# steps moved down; the config's 1e-3 kills none in a run this short
SEARCH_GAMMA_THRESHOLD = 1.0
SEARCH_TIMING_STEPS = 5
RETRAIN_BATCH = 256  # the config's 1024 is spread over many chips
RETRAIN_STEPS = 4
# the search's one-step parity check on the card: these gammas of every
# prunable block start far below this threshold, so the event kills them on
# both devices whatever float32 rounding does to the rest
PARITY_GAMMA_THRESHOLD = 0.1
PARITY_DEAD_EVERY = 7
# The supernet's first f32 step at init is ill-conditioned: its early-layer
# gradients are sums with heavy cancellation (grad norm 24, against 1.0 for
# MobileNetV3-Large). Measured on an NVIDIA H100 80GB HBM3 at 700 W, three
# float32 implementations of the same step differ pairwise in params by
# 4.3e-6 (the CPU at 1 and at 8 threads), 2.7e-5 (the card's cuDNN against
# the CPU) and 4.4e-5 (the card's cuDNN against its native convolutions,
# cuDNN off), above TRAIN_PARAM_TOL, which MobileNetV3-Large meets at 3e-8.
# So the search step's grad norm and params are held at the larger of
# TRAIN_*_TOL and this factor times the same measure between the card's two
# convolution implementations on the same input; loss and penalty stay at
# TRAIN_LOSS_TOL, the masks exact.
SEARCH_SPREAD_FACTOR = 4
# the folded logits against the unfolded forward (tests/test_serve.py)
FOLD_ATOL = 1e-4
SERVED_FORWARDS = 5
SEARCH_SERVE_REQUESTS = 64
# phase 9, the benches at short lengths: each one's main in this process,
# the serve bench's --zoo and --fleet arms as processes beside later phases
BENCH_TIMEOUT_S = 600
BENCH_TRAIN_STEPS = 5
BENCH_CHAOS_REQUESTS = 300
BENCH_SEARCH_STEPS = 4
BENCH_ZOO_REQUESTS = 24
BENCH_FLEET_REQUESTS = 20
BENCH_FLEET_PHASES = "1,4,2"
# phase 10, the serving tier: MobileNetV3-Small (int8) and -Large (f32) at
# 224 in one engine, K1's launches per forward of each (one per bneck block)
ZOO_PER_FORWARD = {"small": 11, "big": 15}
ZOO_SINGLES = 24
ZOO_BULK_ROWS = (40, 64)
ZOO_TIMED_ITERS = 50
ZOO_FAULTS = 2  # phase 10 (a): F3's check, the injector's failed dispatches
ZOO_FAULT_REQUESTS = 4
FRONT_DOOR_IMAGES = 8
PROFILED_REQUESTS = 4
DRAIN_CLIENTS = 4
DRAIN_REQUESTS = 12
FLEET_IMAGES = 24
KILL_CLIENTS = 4
KILL_REQUESTS = 15
# phase 11, the life of a run: MobileNetV2 1.0 at 224 (the model of
# apps/eval_mobilenet_v2.yml, acceptance config #1) from a torchvision-layout
# state_dict made from seeded tensors (none is in the repository)
LIFE_EVAL_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "eval_mobilenet_v2.yml")
LIFE_TRAIN_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "mobilenet_v2.yml")
LIFE_EVAL_IMAGES = 100
# the classifier's init scale: logits of a few units, so that no two classes
# of an image tie within float32 rounding (the card's top-1 against the CPU's)
LIFE_CLASSIFIER_STD = 0.02
# apps/mobilenet_v2.yml cut to one card and a short run: batch 64 (the app's
# 1024 is spread over many chips), 3 steps an epoch, 4 epochs, a checkpoint
# at every epoch's end, the eval only at the end
LIFE_BATCH = 64
LIFE_STEPS_PER_EPOCH = 3
LIFE_CUTS = [f"train.batch_size={LIFE_BATCH}", f"data.fake_train_size={LIFE_BATCH * LIFE_STEPS_PER_EPOCH}",
             f"data.fake_eval_size={LIFE_BATCH}", f"train.eval_batch_size={LIFE_BATCH}", "train.epochs=4",
             f"train.log_every={LIFE_STEPS_PER_EPOCH}", "train.eval_every_epochs=0",
             "train.checkpoint_every_epochs=1", "data.dataset=fake", f"data.image_size={IMAGE_SIZE}"]
# the injector's SIGTERM after the batch of step index 7: the run stops at step 8
LIFE_KILL_AT = 7
# the resumed run against the uninterrupted one when not bit for bit: this
# factor times two uninterrupted runs' own spread (as SEARCH_SPREAD_FACTOR)
LIFE_SPREAD_FACTOR = 4
LIFE_PER_FORWARD = 17  # MobileNetV2's depthwise stages, one K1 launch each
LIFE_SERVE_REQUESTS = 64
LIFE_TIMED_STEPS = 8
LIFE_EVAL_TIMED_IMAGES = 640  # the config's defaults (data.fake_eval_size, train.eval_batch_size), as phase 7's eval
LIFE_EVAL_TIMED_BATCH = 250
OBS_TOOL_TIMEOUT_S = 120
# phase 13, the real-data input path: MobileNetV2 1.0 at 224 (apps/mobilenet_v2.yml, bf16) trained from JPEGs
REAL_APP = LIFE_TRAIN_APP
REAL_CLASSES = 10
REAL_TRAIN_PER_CLASS = 128
REAL_VAL_PER_CLASS = 50
REAL_VAL_IMAGES = REAL_CLASSES * REAL_VAL_PER_CLASS
REAL_VAL_SHARDS = 2
REAL_TRAIN_SHARDS = 4  # the TFRecord train stream of the resume check
REAL_QUALITY = 90
REAL_BATCH = 256  # apps/mobilenet_v2.yml's global 1024, cut to one card
REAL_STEPS = 16
REAL_STEPS_PER_EPOCH = REAL_CLASSES * REAL_TRAIN_PER_CLASS // REAL_BATCH
REAL_LOG_EVERY = 2
REAL_PROFILE_AFTER = 7  # the window opens after step 7 and holds steps 8-11
# ms per step: the median of the 2-step log windows after step 4, leaving out
# those the profiler window touches (steps 8-12: it opens after step 7 and
# its closing synchronize lands in step 12's window)
REAL_WARMUP_STEPS = 4
REAL_PROFILE_STEPS = 4
REAL_LOADER_BATCHES = 4  # timed batches of the loader alone (1 at one thread)
# the TFRecord stream's index simulation at ImageNet's scale: one host's epoch
# of 1,281,167 records in the train split's 1024 shards, timed ORDER_EPOCHS
# times against the bar
ORDER_SHARDS = 1024
ORDER_EPOCHS = 3
ORDER_SECONDS_BAR = 2.0
# the busy card beside the loader: a graph of this many bf16 matmuls of this
# side (about 1.1 TFLOP each)
BUSY_MATMULS = 20
BUSY_DIM = 8192
REAL_RESUME_BATCH = 64
# restart points: mid-epoch, and the last batch of the first epoch (an epoch
# is 20 batches of REAL_RESUME_BATCH), so that the restarted batches cross
# into the next epoch
REAL_RESUME_AT = (8, 19)
REAL_RESUME_STEPS = 24
REAL_SERVE_REQUESTS = 64
REAL_SERVE_BUCKET = 32
# the run fed by the loader is paced by the host when its step is this much
# slower than the same run fed by the fake stream (made on the device)
HOST_PACED_FACTOR = 1.1
# nvJPEG (the card's machine has no libjpeg) against the committed libjpeg
# decodes of tests/fixtures/torch_jpeg, in pixel levels: (max, mean) allowed.
# A 4:2:0 or 4:2:2 image comes back from nvJPEG as its planes, and the host
# upsamples and converts them as libjpeg does (csrc/nvjpeg_compat/
# libjpeg_upsample.cc): measured max 3 / mean 0.047 at 4:2:0, max 3 / mean
# 0.036 at 4:2:2 (the IDCT's rounding), on an NVIDIA H100 80GB HBM3 at 700 W
# (nvJPEG 12.4.0), in three runs alike; nvJPEG's own
# upsampling gave max 30 / mean 4.8 at 4:2:0, which this bar refuses. A
# 4:4:4 image comes back as its planes too and the host converts them as
# libjpeg does: max 3 / mean 0.05 (nvJPEG's own conversion gave max 4 /
# mean 0.52). The reduced scale (chroma replicated, then block means against
# libjpeg's reduced IDCT): max 3 / mean 0.20 at 4:2:0 (1/2), max 2 / mean
# 0.41 at 4:4:4 (1/4, noise_444_t16). A build against libjpeg must
# reproduce them exactly.
NVJPEG_TOL = {"4:2:0": (3, 0.1), "4:2:2": (3, 0.1), "4:4:4": (3, 0.1), "reduced": (5, 1.0)}
# cold timing: a write of this many bytes (more than the H100's 50 MB L2)
# before each timed launch evicts what the last launch left in L2
FLUSH_BYTES = 128 << 20


def log(msg: str) -> None:
    print(msg, flush=True)



def tf32_off(why: str) -> None:
    """Turn TF32 off (``set_tf32("float32")``, process-wide) for a phase that
    holds float32 results at a float32 bar, and say so: the CLIs and the
    engine set TF32 from their own compute dtype, so a phase cannot rely on
    what ran before it."""
    from yet_another_mobilenet_series_tpu_torch.utils.device import set_tf32

    set_tf32("float32")
    log(f"TF32 off for this phase: {why}")

def card_rates(name: str) -> tuple[float, float, str]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return _BW[key], _F32[key], key
    return _BW["SXM"], _F32["SXM"], "SXM"


def stage_bound(n, h, c, k, s, itemsize, rates) -> tuple[float, str, int]:
    """(bound ms, what bounds it, bytes) of one depthwise stage: each input
    read once and each output written once (x and y in ``itemsize`` bytes,
    the taps and the three (C,) vectors in float32) over the memory rate,
    against 2k^2 + 4 float32 operations per output over the float32 rate."""
    bw, f32_rate, _ = rates
    oh = (h - 1) // s + 1
    out_elems = n * oh * oh * c
    nbytes = itemsize * (n * h * h * c + out_elems) + 4 * (k * k * c + 3 * c)
    flops = out_elems * (2 * k * k + 4)
    by_bytes, by_ops = nbytes / bw, flops / f32_rate
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations", nbytes


def mbv3_depthwise_shapes(batch: int = 32, arch: str = "mobilenet_v3_large"):
    """(n, h, c, k, stride, act) of every depthwise branch of ``arch`` 1.0 at
    224 (MobileNetV3-Large by default), in forward order, from the port's
    own ``get_model``."""
    from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
    from yet_another_mobilenet_series_tpu_torch.models import get_model

    net = get_model(ModelConfig(arch=arch), image_size=224)
    h = (224 - 1) // net.stem.stride + 1
    shapes = []
    for blk in net.blocks:
        for _, k, g, _ in blk._branches():
            shapes.append((batch, h, g, k, blk.stride, blk.active_fn))
        h = (h - 1) // blk.stride + 1
    return net, shapes


def kernel_operands(n, h, c, k, dtype, gen, device):
    import torch

    x = torch.randn((n, h, h, c), generator=gen, device=device).to(dtype)
    w = (torch.randn((k, k, c), generator=gen, device=device) * 0.2).contiguous()
    scale = torch.rand(c, generator=gen, device=device) + 0.5
    shift = (torch.rand(c, generator=gen, device=device) - 0.5) * 0.6
    mask = torch.ones(c, device=device)
    mask[::3] = 0.0
    return x, w, scale, shift, mask


def compare(y, ref, atol, rtol) -> tuple[float, bool]:
    import torch

    err = (y.float() - ref.float()).abs()
    ok = bool(torch.all(err <= atol + rtol * ref.float().abs()).item()) and bool(torch.isfinite(y).all().item())
    return float(err.max().item()), ok


def _timed(fn, *args):
    """``fn(*args)`` and the clock when it returned."""
    out = fn(*args)
    return out, time.perf_counter()


def _host_build() -> tuple[str, dict]:
    """Phase 13 (a)'s host library compiled (g++, ``ops/host_build.py``),
    not yet loaded; its path and what the build did."""
    from yet_another_mobilenet_series_tpu_torch.ops import host_build

    path = host_build.build()
    return path, dict(host_build.BUILD_INFO)


def start_builds(pool) -> dict:
    """Every build of the run started at once, one compiler process each, on
    ``pool``'s threads: the kernels of the path (one nvcc per source) and
    phase 13's host library (g++). The card's first phases run beside them
    (``main``); ``phase_build`` and ``phase_real_build`` wait for them."""
    from yet_another_mobilenet_series_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    return {"t0": t0, "kernels": {name: pool.submit(_timed, cuda_build.build, name) for name in KERNEL_SOURCES},
            "host": pool.submit(_host_build)}


def phase_build(started: dict) -> dict:
    """Waits for the kernels' builds (``start_builds``: one nvcc each, all at
    once) and prints each one's time and what ptxas reported."""
    from yet_another_mobilenet_series_tpu_torch.ops import cuda_build

    t_wait = time.perf_counter()
    done = {name: future.result() for name, future in started["kernels"].items()}
    names = list(done)
    paths = [done[name][0] for name in names]
    wall = max(end for _, end in done.values()) - started["t0"]
    log(f"build: waited {time.perf_counter() - t_wait:.1f} s for the kernels' builds, started "
        f"{t_wait - started['t0']:.1f} s before")
    for name, path in zip(names, paths):
        info = cuda_build.BUILD_INFO[name]
        ptxas = [line for line in info["log"].splitlines() if "registers" in line or "spill" in line]
        log(f"build {name}: {info['seconds']:.1f}s{' (cached)' if info['cached'] else ''} -> {path}")
        for line in ptxas:
            log(f"  ptxas: {line.strip()}")
    log(f"build wall: {wall:.1f}s")
    return {"seconds": wall, "waited_s": time.perf_counter() - t_wait}


def phase_kernel_checks(device, tmp: str) -> dict:
    """Kernel vs plain version on the card: the MBV3-L stages, the Pallas
    grid, channel slices on both paths, and a multi-branch net's logits."""
    tf32_off("the kernel against its plain version at the float32 bar")
    import torch

    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import (
        fused_depthwise, fused_depthwise_reference)

    from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw

    gen = torch.Generator(device=device).manual_seed(0)
    # every serving bucket: the plan tiles each batch differently
    shapes = [shape for batch in BUCKETS for shape in mbv3_depthwise_shapes(batch)[1]]
    small_shapes = mbv3_depthwise_shapes(32, "mobilenet_v3_small")[1]
    plans = {(n, h, c, k, s, item): fdw.plan(n, h, h, c, k, s, item, True)
             for (n, h, c, k, s, _) in shapes for item in (4, 2)}
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    failures = []

    def check(tag, y, ref, dtype, case):
        tol = (F32_TOL, F32_TOL) if dtype == torch.float32 else (BF16_ATOL, BF16_RTOL)
        err, ok = compare(y, ref, *tol)
        errs[dtype] = max(errs[dtype], err)
        if not ok or y.shape != ref.shape:
            failures.append((tag, *case, str(dtype), err))

    grid = [(2, 12, 16, k, s, act) for k in (3, 5, 7) for s in (1, 2)
            for act in ("relu6", "hswish", "swish", "relu")]
    grid += [(2, 9, c, 3, s, "hswish") for c in (160, 200) for s in (1, 2)]
    with torch.inference_mode():
        for tag, cases in (("mbv3", shapes), ("mbv3_small", small_shapes), ("grid", grid)):
            for case in cases:
                n, h, c, k, s, act = case
                for dtype in (torch.float32, torch.bfloat16):
                    ops = kernel_operands(n, h, c, k, dtype, gen, device)
                    y = fused_depthwise(*ops, s, act)
                    torch.cuda.synchronize()
                    check(tag, y, fused_depthwise_reference(*ops, s, act), dtype, case)
        slices = check_channel_slices(device, gen, check)
    log(f"kernel vs plain: {len(shapes)} MBV3-L stages (15 at each of batches {'/'.join(map(str, BUCKETS))}, "
        f"{len(set(plans.values()))} distinct tilings) + {len(small_shapes)} MBV3-S stages at batch 32 + "
        f"{len(grid)} grid cases + {slices} channel slices, "
        f"f32 and bf16: max |err| f32 {errs[torch.float32]:.3e} (tol {F32_TOL}), bf16 {errs[torch.bfloat16]:.3e} "
        f"(atol {BF16_ATOL}, rtol {BF16_RTOL:.4g})")
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures[:5]}")
    branch_err = check_branch_net(device, tmp)
    return {"max_f32": errs[torch.float32], "max_bf16": errs[torch.bfloat16], "branch_net_max_abs_err": branch_err}


def check_channel_slices(device, gen, check) -> int:
    """AtomNAS-style branches: channel slices of one wide NHWC input written
    into slices of one wide output, in place. A slice at a channel offset
    that is not a multiple of the 16-byte vector takes the scalar path, one
    at a multiple of it the vector path; both against the plain version on
    contiguous copies, and the channels outside the slices stay untouched."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw

    n, h, wide, k, s, act = 8, 28, 120, 5, 1, "hswish"
    count = 0
    for dtype in (torch.float32, torch.bfloat16):
        vec = 16 // torch.empty((), dtype=dtype).element_size()
        # (offset, channels, vector path?): off 3 and 53 are not multiples
        # of 4 or 8; 64 is a multiple of both
        branches = [(3, 45, False), (64, 48, True), (53, 8, False)]
        x = torch.randn((n, h, h, wide), generator=gen, device=device).to(dtype)
        out = torch.full((n, h, h, wide), float("nan"), device=device, dtype=dtype)
        for off, g, vector in branches:
            ops = kernel_operands(n, h, g, k, dtype, gen, device)[1:]
            xs, ys = x[..., off: off + g], out[..., off: off + g]
            p = fdw.launch_plan(xs, k, s, ys)
            if (p.vec == vec) != vector:
                raise AssertionError(f"slice at offset {off}, {g} channels, {dtype}: vec {p.vec}, "
                                     f"{'vector' if vector else 'scalar'} path expected")
            fdw.fused_depthwise(xs, *ops, s, act, out=ys)
            torch.cuda.synchronize()
            check("slice", ys, fdw.fused_depthwise_reference(xs.contiguous(), *ops, s, act), dtype,
                  (n, h, g, k, s, act, off))
            count += 1
        untouched = torch.ones(wide, dtype=torch.bool, device=device)
        for off, g, _ in branches:
            untouched[off: off + g] = False
        if not torch.isnan(out[..., untouched].float()).all():
            raise AssertionError("a slice launch wrote outside its channels")
    return count


def check_branch_net(device, tmp: str) -> float:
    """A tiny net whose blocks split their channels into k = 3/5/7 branches
    (one branch at an offset off the 16-byte vector): the card's folded
    logits against the port's CPU forward of the same bundle."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.config import ModelConfig
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle

    specs = [{"t": 2, "c": 8, "n": 1, "s": 2, "k": [3, 5], "se": 0.25},
             {"t": 3, "c": 16, "n": 2, "s": 2, "k": [3, 5, 7]},
             {"t": 2.5, "c": 24, "n": 1, "s": 1, "k": [3, 5, 7]}]
    net = get_model(ModelConfig(arch="mobilenet_v2", num_classes=10, dropout=0.0, block_specs=specs),
                    image_size=32)
    groups = [b.group_channels for b in net.blocks if len(b.group_channels) > 1]
    if not any(g % 4 for gs in groups for g in gs):
        raise AssertionError(f"no branch off the 16-byte vector in {groups}")
    gen = torch.Generator().manual_seed(3)
    params, _ = net.init(gen)
    bundle_dir = os.path.join(tmp, "branch_bundle")
    export_bundle(net, params, random_bn_state(net, gen), bundle_dir, model_name="branches")
    bundle = load_bundle(bundle_dir)
    x = np.random.RandomState(4).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    on_card = InferenceEngine(bundle, device=str(device), buckets=(4,)).predict(x)
    on_cpu = InferenceEngine(bundle, device="cpu", buckets=(4,)).predict(x)
    err = float(np.abs(on_card - on_cpu).max())
    ok = on_card.shape == (4, 10) and bool(np.all(np.abs(on_card - on_cpu) <= SLICE_ATOL + SLICE_RTOL * np.abs(on_cpu)))
    log(f"multi-branch net (branches {groups}), card vs CPU forward (f32): max |err| {err:.3e}, max |logit| "
        f"{float(np.abs(on_cpu).max()):.3e} (atol {SLICE_ATOL}, rtol {SLICE_RTOL})")
    if not ok:
        raise AssertionError(f"multi-branch logits on the card differ from the CPU forward by {err:.3e}")
    return err


def time_stages(device, rates, shapes=None) -> dict:
    """Times at the main path's shapes (batch 32; ``shapes``, (n, h, c, k,
    stride, act) each, default MobileNetV3-Large's 15 stages), float32 and
    bfloat16: the kernel warm back to back (``ms``), warm on the device
    alone (``device_ms``) and cold, F.conv2d(groups=C, bias) the same three
    ways, the plain version, the bound and the cold share of it; then the
    host cost of the wrapper and of F.conv2d. Uses only the wrapper's
    positional API, which every version of the port has
    (scripts/ab_fused_depthwise.py runs it on two checkouts)."""
    tf32_off("F.conv2d timed in float32 beside the float32 kernel")
    import torch
    import torch.nn.functional as F

    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import (
        fused_depthwise, fused_depthwise_reference)

    gen = torch.Generator(device=device).manual_seed(1)
    shapes = shapes or mbv3_depthwise_shapes(32)[1]
    flush = torch.empty(FLUSH_BYTES // 4, device=device)
    clean = torch.zeros(FLUSH_BYTES // 4, device=device)
    rows = []
    with torch.inference_mode():
        for (n, h, c, k, s, act) in shapes:
            row = {"n": n, "h": h, "c": c, "k": k, "stride": s, "act": act}
            for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "bf16_")):
                x, w, scale, shift, mask = kernel_operands(n, h, c, k, dtype, gen, device)
                x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view of the NHWC input
                w_oihw = w.permute(2, 0, 1).unsqueeze(1).to(dtype).contiguous()
                bias = shift.to(dtype)

                def kernel():
                    fused_depthwise(x, w, scale, shift, mask, s, act)

                def library():
                    F.conv2d(x_cl, w_oihw, bias, stride=s, padding=k // 2, groups=c)

                row[tag + "ms"] = cuda_time_ms(kernel)
                row[tag + "device_ms"] = device_time_ms(kernel)
                row[tag + "cold_ms"] = cold_time_ms(kernel, flush)
                row[tag + "cold_clean_ms"] = cold_time_ms(kernel, flush, clean)
                row[tag + "plain_ms"] = cuda_time_ms(
                    lambda: fused_depthwise_reference(x, w, scale, shift, mask, s, act))
                row[tag + "library_ms"] = cuda_time_ms(library)
                row[tag + "library_device_ms"] = device_time_ms(library)
                row[tag + "library_cold_ms"] = cold_time_ms(library, flush)
                bound = stage_bound(n, h, c, k, s, x.element_size(), rates)
                row[tag + "bound_ms"], row[tag + "bound_by"], row[tag + "bytes"] = bound
                row[tag + "share"] = row[tag + "bound_ms"] / row[tag + "cold_ms"]
            rows.append(row)
            log(f"  dw n={n} h={h:3d} c={c:3d} k={k} s={s} {act:6s}: "
                + "; ".join(f"{name} kernel {row[t + 'ms']:.4f} back to back / {row[t + 'device_ms']:.4f} device "
                            f"/ {row[t + 'cold_ms']:.4f} cold ms, conv2d {row[t + 'library_ms']:.4f} / "
                            f"{row[t + 'library_device_ms']:.4f} / {row[t + 'library_cold_ms']:.4f}, "
                            f"plain {row[t + 'plain_ms']:.4f}, bound {row[t + 'bound_ms']:.4f} "
                            f"({100 * row[t + 'share']:.1f}% cold)"
                            for name, t in (("f32", ""), ("bf16", "bf16_"))))
        del flush, clean
        # host cost of the wrapper and of F.conv2d: calls over the stages
        # in turn, no synchronize
        operands = [(kernel_operands(n, h, c, k, torch.float32, gen, device), k, s, act)
                    for (n, h, c, k, s, act) in shapes]
        conv_operands = [(x.permute(0, 3, 1, 2), w.permute(2, 0, 1).unsqueeze(1).contiguous(), shift, k, s)
                         for (x, w, _, shift, _), k, s, _ in operands]

        def all_stages():
            for ops, _, s, act in operands:
                fused_depthwise(*ops, s, act)

        def all_convs():
            for x_cl, w_oihw, bias, k, s in conv_operands:
                F.conv2d(x_cl, w_oihw, bias, stride=s, padding=k // 2, groups=x_cl.shape[1])

        host_us = host_us_per_call(all_stages) / len(operands)
        library_host_us = host_us_per_call(all_convs) / len(operands)
    keys = [t + m for t in ("", "bf16_") for m in ("ms", "device_ms", "cold_ms", "cold_clean_ms", "plain_ms",
                                                   "library_ms", "library_device_ms", "library_cold_ms",
                                                   "bound_ms")]
    totals = {key: sum(r[key] for r in rows) for key in keys}
    totals["host_us_per_launch"] = host_us
    totals["library_host_us_per_call"] = library_host_us
    for name, t in (("f32", ""), ("bf16", "bf16_")):
        totals[t + "share"] = totals[t + "bound_ms"] / totals[t + "cold_ms"]
        log(f"{len(rows)} stages at batch 32, {name}: kernel {totals[t + 'ms']:.4f} ms back to back / "
            f"{totals[t + 'device_ms']:.4f} ms device / {totals[t + 'cold_ms']:.4f} ms cold, F.conv2d(groups=C, "
            f"bias) without the activation {totals[t + 'library_ms']:.4f} / {totals[t + 'library_device_ms']:.4f} / "
            f"{totals[t + 'library_cold_ms']:.4f} ms, plain {totals[t + 'plain_ms']:.4f} ms, bound "
            f"{totals[t + 'bound_ms']:.4f} ms ({sum(r[t + 'bytes'] for r in rows) / 1e6:.1f} MB at "
            f"{rates[0] / 1e12:.2f} TB/s, H100 {rates[2]}); cold share of the bound {100 * totals[t + 'share']:.1f}%; "
            f"cold with a clean L2 (no write-back of the flush) {totals[t + 'cold_clean_ms']:.4f} ms")
    log(f"host cost: wrapper {host_us:.2f} us per launch, F.conv2d {library_host_us:.2f} us per call "
        f"({len(rows)} stages in turn, no synchronize)")
    return {"rows": rows, "totals": totals, "bytes": sum(r["bytes"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"}


def _fresh_bundle(tmp: str) -> tuple[str, object]:
    """MobileNetV3-Large 1.0 at 224 with seeded weights, exported as the
    serving bundle; returns its directory and the net."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle

    net, _ = mbv3_depthwise_shapes(32)
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    bundle_dir = os.path.join(tmp, "bundle")
    export_bundle(net, params, random_bn_state(net, gen), bundle_dir, model_name="mobilenet_v3_large")
    return bundle_dir, net


def _k1_on_card() -> int:
    """K1's launches that ran on the card in this process so far: the
    kernel's own counter (``fused_depthwise.device_launches``, one per launch
    that ran, each graph replay included) summed over the visible cards. A
    synchronizing read, made outside every capture region."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import device_launches

    return sum(device_launches(i) for i in range(torch.cuda.device_count()))


def _k1_card_gate(before: int, want: int, what: str, profiled: int | None = None) -> int:
    """The card's own count of K1's launches since ``before`` (a reading
    of ``_k1_on_card``), held by ``_k1_check``."""
    return _k1_check(_k1_on_card() - before, want, what, profiled)


def _k1_check(count: int, want: int, what: str, profiled: int | None = None) -> int:
    """Fails unless ``count``, K1's launches on the card's own counter,
    equals ``want`` (warm runs plus replays x captured launches for graph
    runs, the wrapper's count for eager calls), or where the profiler's
    count of the same calls (``profiled``) is above it: a profiler may drop
    records, never add them."""
    if count != want:
        raise AssertionError(f"{what}: the card ran {count} fused_dw_kernel launches (its own counter), the "
                             f"accounting says {want}")
    if profiled is not None and profiled > count:
        raise AssertionError(f"{what}: the profiler saw {profiled} fused_dw_kernel launches, more than the {count} "
                             "the card ran")
    return count


def _k1_accounting(graphs: list[dict], wrapper_launches: int, per_forward) -> dict:
    """K1's launches in one run of the engine, from its graph report (every
    key was captured in this run): each graph must hold ``per_forward``
    launches per forward it runs (K for a fused key, R for a ring, each
    lane of a mesh key its own; a dict
    gives each tenant of a zoo engine its own), its eager warm run the
    same, and the wrapper must have launched nothing outside warm runs and
    captures (every dispatch a replay). The card ran the warm runs'
    launches plus replays x captured launches: a product of counters, held
    against the kernel's own count on the card by ``_k1_card_gate``."""
    def want(g) -> int:
        pf = per_forward[g["model"]] if isinstance(per_forward, dict) else per_forward
        return pf * g["key"][2] * g.get("lanes", 1)

    bad = [g for g in graphs if g["k1_launches"] != want(g) or g["warm_k1"] != want(g)]
    if bad:
        raise AssertionError(f"graphs without {per_forward} K1 launches per forward: {bad}")
    warm = sum(g["warm_k1"] for g in graphs)
    captured = sum(g["k1_launches"] for g in graphs)
    if wrapper_launches != warm + captured:
        raise AssertionError(f"the wrapper launched {wrapper_launches} times, but warm runs and captures account "
                             f"for {warm + captured}: a dispatch ran eagerly")
    replayed = sum(g["replays"] * g["k1_launches"] for g in graphs)
    return {"launches": warm + replayed, "replayed": replayed, "captured": captured, "warm": warm,
            "forwards": sum(g["key"][2] * g.get("lanes", 1) * (1 + g["replays"]) for g in graphs)}


def _device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, device us, count) of every kernel a ``torch.profiler`` run saw
    on the card, busiest first. Device-side events only: a CPU op's self
    device time repeats the kernels it launched."""
    import torch

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)))

    return sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0), key=lambda r: -r[1])


def _profiled_k1(prof) -> int:
    """K1's launches in a profile, as many as the profiler kept records of."""
    return sum(c for name, _, c in _device_kernels(prof) if "fused_dw_kernel" in name)


def _profiled_windows(run, calls: int):
    """``calls`` calls of ``run`` in each of two torch.profiler windows, the
    card synchronized before each window and before its end; the profile of
    the second window, K1's launches in each as the profiler kept them and
    as the card counted them (``_k1_on_card``), and the second's wall time
    in us. Kernel shares and device times come from the second window: the
    first replay of a graph under a new profiler can lose its kernels'
    records (a window of one forward saw 8 of its 15 K1 launches once, and a
    fresh process's window of 5 searched-net forwards 204 of 255 once, on an
    NVIDIA H100 80GB HBM3 at 700 W). A count that gates comes from the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen, card = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        before = _k1_on_card()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        card.append(_k1_on_card() - before)
        seen.append(_profiled_k1(prof))
    return prof, seen, card, wall_us


def _cpu_check(tag: str, on_card, on_cpu) -> float:
    import numpy as np

    if on_card.shape != on_cpu.shape or not np.isfinite(on_card).all():
        raise AssertionError(f"{tag}: bad logits from the card: shape {on_card.shape}")
    err = float(np.abs(on_card - on_cpu).max())
    if not np.all(np.abs(on_card - on_cpu) <= SLICE_ATOL + SLICE_RTOL * np.abs(on_cpu)):
        raise AssertionError(f"{tag}: card logits differ from the CPU forward by {err:.3e}")
    return err


def _ladder_keys(cfg) -> set:
    """The (kind, key) of every graph an engine of ``cfg`` captures at
    warmup: each (bucket, size), the fused (cap, size, K) and the ring."""
    cap = max(cfg.serve.buckets)
    keys = set()
    for size in set(cfg.serve.image_sizes or ()) | {cfg.data.image_size}:
        keys |= {("k", (b, size, 1)) for b in cfg.serve.buckets}
        if cfg.serve.fuse_chunks.enable:
            keys |= {("k", (cap, size, k)) for k in cfg.serve.fuse_chunks.ladder if k >= 2}
        if cfg.serve.ring.enable:
            keys.add(("ring", (cap, size, cfg.serve.ring.slots)))
    return keys


def phase_load(device, tmp: str, bundle_dir: str, tag: str, overrides: list[str], per_forward: int) -> dict:
    """One load of the shipped config (plus ``overrides``) on the card.

    First the port's entry point, ``cli/serve.py``'s ``run(cfg, device)``:
    it loads the bundle, captures every key at warmup and drives
    SERVE_REQUESTS single-image requests from SERVE_CLIENTS closed-loop
    clients through the pipelined batcher. The counts are set to 0 just
    before and read just after. Gates: every request completes, 0 shed, 0
    rejected; the graphs are the ladder's, each captured once at warmup;
    every dispatch is a replay; K1 runs ``per_forward`` launches per
    forward and none outside warm runs and captures, and the card's own
    count of K1's launches equals warm runs + replays x captured launches.

    Then traffic that single images do not make, on an engine built the
    same way (``engine_kwargs``, ``_make_batcher``): a bulk client sending
    requests of more than 32 rows to ``engine.predict`` (the fused ladder)
    beside a burst client submitting BURST_IMAGES images at once, BURSTS
    times (a queue deep enough for the ring), under ``torch.profiler``.
    Gates: every dispatch a replay, fused dispatches (and ring windows with
    the ring) ran, the card's own count of K1 launches equals the graphs'
    replays x captured launches (the profiler's count printed beside it,
    never above), and the logits match the port's CPU forward
    (SLICE_ATOL/SLICE_RTOL)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import load_bundle

    cfg = parse_cli([f"app:{APP}", f"serve.bundle={bundle_dir}", f"serve.requests={SERVE_REQUESTS}",
                     f"serve.clients={SERVE_CLIENTS}", "serve.compute_dtype=float32", f"data.image_size={IMAGE_SIZE}",
                     f"train.log_dir={os.path.join(tmp, 'log_' + tag)}", *overrides])
    wire = cfg.serve.quant.wire

    # the main path: the CLI's run(), counts at 0 just before, read just after
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    card0 = _k1_on_card()
    t0 = time.perf_counter()
    result = serve_cli.run(cfg, device=str(device))
    run_s = time.perf_counter() - t0
    launches = fused_depthwise.launches
    graphs = result["graphs"]
    k1 = _k1_accounting(graphs, launches, per_forward)
    k1["card"] = _k1_card_gate(card0, k1["launches"], f"load {tag} (cli.serve.run)")
    keys = {(g["kind"], tuple(g["key"])) for g in graphs}
    result.update(tag=tag, overrides=overrides, run_s=run_s, k1=k1, wrapper_launches=launches)
    order = result.pop("latency_ms_by_completion")
    slowest = sorted(range(len(order)), key=lambda i: -order[i])[:3]
    log(f"load {tag} (cli.serve.run): {result['completed']}/{result['requests']} requests, {result['shed']} shed, "
        f"{result['rejected_full']} rejected, {result['qps']:.1f} QPS, p50 {result['p50_ms']:.2f} ms, "
        f"p99 {result['p99_ms']:.2f} ms (slowest by completion index: "
        + ", ".join(f"#{i} {order[i]:.2f} ms" for i in slowest)
        + f"); {result['dispatches']} dispatches = {result['replays']} graph replays; {result['warmup_forwards']} "
        f"captures for {len(graphs)} graphs; K1 {k1['launches']} launches = {k1['warm']} in warm runs + "
        f"{k1['replayed']} in replays ({per_forward} x {k1['forwards']} forwards; wrapper {launches} = warm "
        f"runs + captures), {k1['card']} on the card's own counter; {run_s:.2f} s")
    if result["completed"] != SERVE_REQUESTS or result["shed"] or result["rejected_full"] or result["client_crashes"]:
        raise AssertionError(f"load {tag}: not every request completed: {result}")
    if keys != _ladder_keys(cfg) or result["warmup_forwards"] != len(graphs):
        raise AssertionError(f"load {tag}: graphs {sorted(keys)} from {result['warmup_forwards']} captures, the "
                             f"ladder is {sorted(_ladder_keys(cfg))}")
    if not result["dispatches"] or result["dispatches"] != result["replays"]:
        raise AssertionError(f"load {tag}: {result['dispatches']} dispatches, {result['replays']} replays")

    # bulk and burst traffic on an engine built the same way, profiled
    reg = get_registry()
    rng = np.random.RandomState(7)

    def images(n):
        if wire == "uint8":
            return rng.randint(0, 256, (n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8)
        return rng.normal(0, 1, (n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)

    bulk_in = [images(BULK_ROWS[i % len(BULK_ROWS)]) for i in range(BULK_REQUESTS)]
    burst_in = images(BURST_IMAGES)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    engine = InferenceEngine(load_bundle(bundle_dir), device=str(device), **serve_cli.engine_kwargs(cfg))
    engine.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    graph_mb = (torch.cuda.memory_reserved(device) - mem0) / 1e6
    warm, wrapper0, card0 = reg.snapshot(), fused_depthwise.launches, _k1_on_card()
    batcher = serve_cli._make_batcher(cfg, engine).start()
    box: dict = {"bulk": [], "burst": [], "errors": []}

    def bulk():
        try:
            for x in bulk_in:
                t = time.perf_counter()
                box["bulk"].append((engine.predict(x), (time.perf_counter() - t) * 1e3))
        except BaseException as e:  # re-raised below, in the main thread
            box["errors"].append(e)

    def burst():
        try:
            for _ in range(BURSTS):
                futs = [batcher.submit(img) for img in burst_in]
                box["burst"].append(np.stack([f.result(timeout=120) for f in futs]))
        except BaseException as e:  # re-raised below, in the main thread
            box["errors"].append(e)

    closed_loop_image = serve_cli._synthetic_image(np.random.RandomState(0), IMAGE_SIZE, wire)
    extra = [threading.Thread(target=bulk), threading.Thread(target=burst)]
    # the count gates on the card's counter; the window stays because this
    # traffic's mix of fused dispatches and ring windows was set under the
    # profiler's host cost (how deep the batcher's queue gets)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_load = time.perf_counter()
        try:
            for t in extra:
                t.start()
        finally:
            for t in extra:
                t.join()
            load_s = time.perf_counter() - t_load
            single = batcher.submit(closed_loop_image).result(timeout=60) if not box["errors"] else None
            batcher.stop()
        torch.cuda.synchronize()
    after = reg.snapshot()
    if box["errors"]:
        raise box["errors"][0]

    def delta(key: str) -> int:
        return int(after.get(key, 0) - warm.get(key, 0))

    report = engine.graph_report()
    replayed = sum(g["replays"] * g["k1_launches"] for g in report)
    eager_k1 = fused_depthwise.launches - wrapper0
    profiled = _profiled_k1(prof)
    traffic = {"warmup_s": warmup_s, "graph_mb": graph_mb, "dispatches": delta("serve.dispatch_seconds.count"),
               "replays": delta("serve.graph_replays"), "fused_dispatches": delta("serve.fused_dispatches"),
               "ring_dispatches": delta("serve.ring_dispatches"), "h2d_bytes": delta("serve.h2d_bytes"),
               "captures": delta("serve.compile_seconds.count"), "eager_k1": eager_k1, "k1_replayed": replayed,
               "k1_device_count": _k1_card_gate(card0, replayed + eager_k1, f"load {tag} traffic", profiled),
               "k1_profiled": profiled,
               "bulk_ms": [ms for _, ms in box["bulk"]], "quant_mode": engine.quant_mode,
               "images_per_s": (sum(len(b) for b in bulk_in) + BURSTS * BURST_IMAGES + 1) / load_s}
    result["traffic"] = traffic
    log(f"load {tag} traffic: {BULK_REQUESTS} bulk requests of {'/'.join(map(str, BULK_ROWS))} rows "
        f"({min(traffic['bulk_ms']):.1f}-{max(traffic['bulk_ms']):.1f} ms each) beside {BURSTS} bursts of "
        f"{BURST_IMAGES}, {traffic['images_per_s']:.0f} images/s under the profiler; {traffic['dispatches']} "
        f"dispatches = {traffic['replays']} graph replays ({traffic['fused_dispatches']} fused, "
        f"{traffic['ring_dispatches']} ring), {traffic['captures']} captures; K1 on the card (its own counter) "
        f"{traffic['k1_device_count']} launches = replays x captured launches {replayed} + {traffic['eager_k1']} "
        f"eager (the profiler kept {profiled}); warmup {warmup_s:.2f} s, {len(report)} graphs, {graph_mb:.1f} MB "
        f"reserved; {engine.quant_mode}")
    if len(box["bulk"]) != BULK_REQUESTS or len(box["burst"]) != BURSTS:
        raise AssertionError(f"load {tag}: {len(box['bulk'])} bulk requests, {len(box['burst'])} bursts completed")
    if (traffic["dispatches"] != traffic["replays"] or traffic["captures"] or traffic["eager_k1"]
            or not traffic["fused_dispatches"]):
        raise AssertionError(f"load {tag} traffic: {traffic}")
    if engine.ring_slots and not traffic["ring_dispatches"]:
        raise AssertionError(f"load {tag}: the ring never engaged")
    del engine

    # the card's logits against the port's CPU forward of the same bundle
    cpu = InferenceEngine(load_bundle(bundle_dir), device="cpu", buckets=(32,), wire=wire,
                          wire_mean=cfg.data.mean, wire_std=cfg.data.std)
    errs = [_cpu_check(f"{tag} bulk", box["bulk"][0][0], cpu.predict(bulk_in[0])),
            _cpu_check(f"{tag} burst", box["burst"][-1][:CPU_ROWS], cpu.predict(burst_in[:CPU_ROWS])),
            _cpu_check(f"{tag} closed loop", single[None], cpu.predict(closed_loop_image[None]))]
    result["logits_max_abs_err"] = max(errs)
    log(f"load {tag} logits, card vs CPU forward (f32): max |err| {max(errs):.3e} "
        f"(atol {SLICE_ATOL}, rtol {SLICE_RTOL}) over a {BULK_ROWS[0]}-row bulk request, "
        f"{CPU_ROWS} burst rows and the closed-loop image")
    return result


def phase_loads(device, tmp: str) -> dict:
    """The three loads of phase 4: the shipped config as shipped (fusion and
    overlap on), then with the ring, then with the uint8 wire."""
    bundle_dir, net = _fresh_bundle(tmp)
    per_forward = sum(1 for blk in net.blocks for _ in blk._branches())
    loads = {tag: phase_load(device, tmp, bundle_dir, tag, overrides, per_forward)
             for tag, overrides in LOADS}
    return {"bundle_dir": bundle_dir, "per_forward": per_forward, "loads": loads,
            "launches": sum(r["k1"]["launches"] for r in loads.values())}


def phase_graph_checks(device, tmp: str, bundle_dir: str) -> dict:
    """Bit for bit on the card: eager forward against graph replay per
    bucket; fused K=2 and K=4 against per-chunk; ring fills 1..R against the
    per-batch path at the same bucket; overlap on against off; two unsynced
    in-flight dispatches of one key against their own eager results; the
    shift-free u8 wire against the f32 wire fed ``normalize_reference``
    pixels. Then an int8 bundle against its own dequantized f32 forward,
    within the JAX package's int8 gate (top-1 agreement >=
    ``serve.quant.int8_top1_min``)."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.config import QuantConfig
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.serve import quant
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle

    bundle = load_bundle(bundle_dir)
    rng = np.random.RandomState(11)
    dev = str(device)
    r = 4
    eng = InferenceEngine(bundle, device=dev, fuse_ladder=(2, 4), ring_slots=r)
    eng.warmup()
    failures = []

    def same(tag, a, b):
        if not np.array_equal(a, b):
            failures.append((tag, float(np.abs(a - b).max())))

    def x(n):
        return rng.normal(0, 1, (n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)

    def eager(a):
        return eng._forward(torch.from_numpy(a).to(device)).cpu().numpy()

    for b in eng.buckets:
        a = x(b)
        same(f"graph vs eager, bucket {b}", eng.predict(a), eager(a))
    for k in (2, 4):
        a = x(32 * k)
        same(f"fused K={k} vs per-chunk", eng.predict(a), np.concatenate([eng.predict(a[i: i + 32])
                                                                          for i in range(0, 32 * k, 32)]))
    per_batch = InferenceEngine(bundle, device=dev, buckets=(32,))
    for fill in range(1, r + 1):
        parts = [x(32) for _ in range(fill - 1)] + [x(17)]
        out = eng.ring_dispatch([eng.ring_stage(p) for p in parts]).result()
        same(f"ring fill {fill}", out, np.concatenate([per_batch.predict(p) for p in parts]))
    over = InferenceEngine(bundle, device=dev, fuse_ladder=(2, 4), overlap_staging=True, staging_slots=2)
    batches = [x(n) for n in (5, 32, 5, 70, 5, 128)]
    handles = [over.predict_async(a) for a in batches]
    for a, h in zip(batches, handles):
        same(f"overlap on vs off, {len(a)} rows", h.result(), eng.predict(a))
    a1, a2 = x(32), x(32)
    h1, h2 = eng.predict_async(a1), eng.predict_async(a2)  # two replays of one key, unsynced
    same("in-flight dispatch 2 of one key", h2.result(), eager(a2))
    same("in-flight dispatch 1 of one key", h1.result(), eager(a1))
    u8 = InferenceEngine(bundle, device=dev, wire="uint8", fuse_ladder=(2,))
    raw = rng.randint(0, 256, (40, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8)
    if not u8.wire_parity_exact:
        raise AssertionError("the u8 engine is not shift-free")
    same("u8 wire vs f32 wire on normalize_reference pixels", u8.predict(raw),
         InferenceEngine(bundle, device=dev, fuse_ladder=(2,)).predict(quant.normalize_reference(raw)))
    log(f"graph checks (bit for bit): {len(eng.buckets)} buckets, fused K=2/4, ring fills 1..{r}, overlap, "
        f"2 in-flight dispatches, u8 wire: {len(failures)} failures {failures}")
    if failures:
        raise AssertionError(f"graph results differ bitwise: {failures}")

    # int8: the bundle's own f32 weights quantized with the gated pass (the
    # gate is recorded, not enforced, on these random weights), served on the
    # card against the f32 bundle of its dequantized weights
    gate = QuantConfig().int8_top1_min
    net = bundle.net
    gen = torch.Generator().manual_seed(0)
    params, _ = net.init(gen)
    calib = quant.normalize_reference(rng.randint(0, 256, (16, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8))
    q_dir = export_bundle(net, params, random_bn_state(net, gen), os.path.join(tmp, "int8"), quant_weights="int8",
                          calib_images=calib, int8_top1_min=0.0, device=dev)
    qb = load_bundle(q_dir)
    if not qb.quant["calib"]["device"].startswith("cuda"):
        raise AssertionError(f"the int8 calibration ran on {qb.quant['calib']['device']}, not on the card")
    f32 = _dequantized(q_dir, net)
    a = rng.randint(0, 256, (64, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8)
    got = InferenceEngine(qb, device=dev, wire="uint8").predict(a)
    want = InferenceEngine(f32, device=dev, wire="uint8").predict(a)
    agree = float(np.mean(np.argmax(got, -1) == np.argmax(want, -1)))
    err = float(np.abs(got - want).max())
    log(f"int8 bundle ({qb.quant['quantized_tensors']} tensors, {qb.quant['bytes_int8'] / 1e6:.2f} MB against "
        f"{qb.quant['bytes_f32'] / 1e6:.2f} MB; export-time top-1 agreement with the f32 fold "
        f"{qb.quant['top1_agreement']:.3f} on 16 calibration images, calibrated on {qb.quant['calib']['device']}) on "
        f"the card vs its dequantized f32 forward: "
        f"top-1 agreement {agree:.3f} (gate {gate}), max |err| {err:.3e}, bitwise {np.array_equal(got, want)}")
    if agree < gate or not np.isfinite(got).all():
        raise AssertionError(f"int8 bundle agrees with its dequantized forward on {agree:.3f} < {gate}")
    return {"failures": failures, "int8_agreement": agree, "int8_max_abs_err": err,
            "int8_export_agreement": qb.quant["top1_agreement"]}


def phase_forward(device, bundle_dir: str, card: str, per_forward: int) -> dict:
    """Where a forward's time goes on the card, eager against graph replay,
    per bucket: the host's enqueue per forward, the device time per forward
    back to back (CUDA events) and on the device alone, the serving path's
    host cost per dispatch (``predict_async``: staging, copy, replay); the
    fused K=4 graph per chunk and the ring R=4 graph per slot; graph memory;
    a new thread's first forward; and a torch.profiler breakdown of five
    batch-32 graph replays by kernel."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import load_bundle

    log(f"timings on {card}: MobileNetV3-Large 1.0 at {IMAGE_SIZE}, f32, eager forward against graph replay")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved(device)
    engine = InferenceEngine(load_bundle(bundle_dir), device=str(device), fuse_ladder=(2, 4), ring_slots=4,
                             overlap_staging=True)
    engine.warmup()
    torch.cuda.synchronize()
    out: dict = {"buckets": {}, "graph_mb": (torch.cuda.memory_reserved(device) - mem0) / 1e6}
    gen = torch.Generator(device=device).manual_seed(2)
    rng = np.random.RandomState(3)

    def enqueue_ms(fn, iters=20) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        return ms

    def idle_host_ms(fn, iters=10) -> float:
        """Host time of one call made with the card idle (no fence to wait
        on): what one dispatch costs the host by itself."""
        total = 0.0
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return total / iters * 1e3

    for b in engine.buckets:
        x = torch.randn((b, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device)
        x_np = rng.normal(0, 1, (b, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
        graph = engine._compiled[("default", b, IMAGE_SIZE, 1)].graph
        row = {"eager_device_ms": cuda_time_ms(lambda: engine._forward(x), iters=20),
               "eager_enqueue_ms": enqueue_ms(lambda: engine._forward(x)),
               "graph_device_ms": cuda_time_ms(graph.replay, iters=20),
               "graph_device_alone_ms": device_time_ms(graph.replay, iters=20),
               "graph_enqueue_ms": enqueue_ms(graph.replay),
               "dispatch_host_ms": idle_host_ms(lambda: engine.predict_async(x_np)),
               "dispatch_pace_ms": enqueue_ms(lambda: engine.predict_async(x_np)),
               "predict_ms": enqueue_ms(lambda: engine.predict(x_np), iters=5)}
        out["buckets"][b] = row
        log(f"forward bucket {b:2d}: eager {row['eager_device_ms']:.3f} ms back to back, host enqueue "
            f"{row['eager_enqueue_ms']:.3f} ms; graph replay {row['graph_device_ms']:.3f} ms back to back / "
            f"{row['graph_device_alone_ms']:.3f} ms on the device alone, host enqueue {row['graph_enqueue_ms']:.4f} "
            f"ms; serving dispatch (predict_async, overlap) {row['dispatch_host_ms']:.3f} ms of host with the card "
            f"idle, {row['dispatch_pace_ms']:.3f} ms each back to back (2 staging slots), predict synchronized "
            f"{row['predict_ms']:.3f} ms")
    k4 = engine._compiled[("default", 32, IMAGE_SIZE, 4)].graph
    ring = engine._compiled[("default", 32, IMAGE_SIZE, 4, "ring")].graph
    out["fused_k4_ms_per_chunk"] = cuda_time_ms(k4.replay, iters=10) / 4
    out["ring_r4_ms_per_slot"] = cuda_time_ms(ring.replay, iters=10) / 4
    # the overlap path's device-to-device copy into a batch-32 graph's
    # static input, from a staging slot's device buffer
    exe32 = engine._compiled[("default", 32, IMAGE_SIZE, 1)]
    slot_dev = engine._staging[(32, IMAGE_SIZE, 1)].slots[0].dev
    out["d2d_copy_ms"] = cuda_time_ms(lambda: exe32.x.copy_(slot_dev), iters=20)
    log(f"batch 32 per forward: K=1 graph {out['buckets'][32]['graph_device_ms']:.3f} ms, fused K=4 graph "
        f"{out['fused_k4_ms_per_chunk']:.3f} ms per chunk, ring R=4 graph {out['ring_r4_ms_per_slot']:.3f} ms per "
        f"slot; the overlap path's copy into the static input {out['d2d_copy_ms'] * 1e3:.1f} us "
        f"({exe32.x.numel() * 4 / 1e6:.1f} MB); graphs and staging of this engine (6 keys, overlap): "
        f"{out['graph_mb']:.1f} MB reserved")

    # the first forward of a thread, eager and through the graph: PyTorch
    # keeps cuDNN/cuBLAS handles per thread, which a replay does not use
    x1 = torch.randn((1, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device)
    x1_np = x1.cpu().numpy()

    def eager_ms() -> float:
        t0 = time.perf_counter()
        engine._forward(x1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def graph_ms() -> float:
        t0 = time.perf_counter()
        engine.predict(x1_np)
        return (time.perf_counter() - t0) * 1e3

    def in_new_thread(fn) -> list[float]:
        box: dict = {}

        def run():
            try:
                box["ms"] = [fn(), fn()]
            except BaseException as e:  # re-raised below, in the main thread
                box["error"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "error" in box:
            raise box["error"]
        return box["ms"]

    out["thread_first_forward_ms"] = {"graph_new_thread": in_new_thread(graph_ms),
                                      "graph_main": graph_ms(),
                                      "eager_new_thread": in_new_thread(eager_ms), "eager_main": eager_ms()}
    t = out["thread_first_forward_ms"]
    log(f"batch-1 forward, synchronized: graph (predict) main thread {t['graph_main']:.2f} ms, a new thread's "
        f"first and second {t['graph_new_thread'][0]:.2f} / {t['graph_new_thread'][1]:.2f} ms; eager main "
        f"{t['eager_main']:.2f} ms, a new thread's {t['eager_new_thread'][0]:.2f} / {t['eager_new_thread'][1]:.2f} ms")

    graph32 = engine._compiled[("default", 32, IMAGE_SIZE, 1)].graph
    prof, seen, card, wall_us = _profiled_windows(graph32.replay, 5)
    kernels = _device_kernels(prof)
    busy_us = sum(us for _, us, _ in kernels)
    for i, (n_card, n_seen) in enumerate(zip(card, seen)):
        _k1_check(n_card, 5 * per_forward, f"5 batch-32 graph replays, profiler window {i + 1}", n_seen)
    dw_count = card[1]
    dw_us = sum(us for name, us, _ in kernels if "fused_dw_kernel" in name)
    out["profile"] = {"wall_us": wall_us, "device_us": busy_us, "fused_dw_us": dw_us, "fused_dw_count": dw_count,
                      "fused_dw_profiled": seen[1], "fused_dw_count_discarded_window": card[0],
                      "fused_dw_profiled_discarded_window": seen[0],
                      "top": [{"kernel": n[:120], "device_us": us, "count": c} for n, us, c in kernels[:15]]}
    log(f"profile, 5 graph replays at batch 32: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
        f"({100 * busy_us / wall_us:.1f}%); fused_dw_kernel {dw_count} launches on the card's own counter "
        f"(the profiler kept {seen[1]}; the discarded first window {card[0]} / {seen[0]}), {dw_us / 1e3:.3f} ms "
        f"({100 * dw_us / busy_us:.1f}% of device time)")
    for name, us, c in kernels[:8]:
        log(f"  {us / 5e3:8.4f} ms/forward  x{c // 5:<4d} {name[:100]}")
    return out


def _train_cfg(tmp: str, tag: str, *overrides: str):
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    return parse_cli([f"app:{TRAIN_APP}", "data.dataset=fake", f"data.image_size={IMAGE_SIZE}",
                      f"train.log_dir={os.path.join(tmp, 'train_' + tag)}", *overrides])


def _scaled_max(a: dict, b: dict) -> float:
    """max |a - b| / (1 + |b|) over two trees of tensors."""
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree

    fa, fb = flatten_tree(a), flatten_tree(b)
    return max(float(((fa[k].cpu() - fb[k].cpu()).abs() / (1.0 + fb[k].cpu().abs())).max()) for k in fb)


def phase_train_parity(device, tmp: str) -> dict:
    """One f32 train step of MobileNetV3-Large at batch TRAIN_CHECK_BATCH on
    the card and on the port's CPU path, from one state and one batch (the
    shipped config in f32, dropout off so that no random draw differs, no
    warmup so that the LR is not 0)."""
    tf32_off("one float32 step, card against CPU")
    cfg = _train_cfg(tmp, "parity", "train.compute_dtype=float32", "model.dropout=0.0", "schedule.warmup_epochs=0")
    return _step_parity(device, cfg, TRAIN_CHECK_BATCH, "MobileNetV3-Large 1.0")


def _step_parity(device, cfg, batch: int, what: str, spread: bool = False) -> dict:
    """One f32 train step of ``cfg``'s net at ``batch`` on the card and on
    the port's CPU path, from one state and one batch: loss, grad norm and
    updated params held at TRAIN_*_TOL. With ``spread``, three more steps:
    on the card with cuDNN off, and on the card and on the CPU with the
    batch's samples in another order (the same step in exact arithmetic);
    grad norm and params held at the larger of TRAIN_*_TOL and
    SEARCH_SPREAD_FACTOR times each device's own spread between those steps
    and its first (phase 8 (a)'s rule, for a step whose float32 result
    turns on the order of its sums)."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

    net = get_model(cfg.model, IMAGE_SIZE)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, batch, 1, 1)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0])
    step = steps.make_train_step(net, cfg, opt, lr_fn)
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (batch, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    y = (np.arange(batch) * 37 % cfg.model.num_classes).astype(np.int32)
    runs = []
    try:
        # the spread's second batch: the same samples in another order, the
        # same step in exact arithmetic, other sums in float32
        order = np.roll(np.arange(batch), batch // 2 - 1)
        for dev, cudnn, rows in ((torch.device("cpu"), True, slice(None)), (device, True, slice(None))) + (
                ((device, False, slice(None)), (device, True, order), (torch.device("cpu"), True, order))
                if spread else ()):
            torch.backends.cudnn.enabled = cudnn
            ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(0), device=dev)
            data = {"image": torch.from_numpy(x[rows]).to(dev), "label": torch.from_numpy(y[rows]).to(dev)}
            t0 = time.perf_counter()
            new, m = step(ts, data, torch.Generator(device=dev).manual_seed(0))
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            runs.append((new, loss, norm, time.perf_counter() - t0))
    finally:
        torch.backends.cudnn.enabled = True
    (cpu, loss_c, norm_c, s_c), (card, loss_g, norm_g, s_g) = runs[:2]
    norm_tol, param_tol, spreads = TRAIN_NORM_TOL, TRAIN_PARAM_TOL, None
    if spread:
        spreads = {tag: {"grad_norm_rel": abs(other[2] - base[2]) / abs(base[2]),
                         "params": _scaled_max(other[0].params, base[0].params)}
                   for tag, other, base in zip(("card native", "card reordered", "CPU reordered"), runs[2:],
                                               (runs[1], runs[1], runs[0]))}
        norm_tol = max(TRAIN_NORM_TOL, SEARCH_SPREAD_FACTOR * max(v["grad_norm_rel"] for v in spreads.values()))
        param_tol = max(TRAIN_PARAM_TOL, SEARCH_SPREAD_FACTOR * max(v["params"] for v in spreads.values()))
    res = {"loss_cpu": loss_c, "loss_card": loss_g, "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
           "grad_norm_cpu": norm_c, "grad_norm_card": norm_g, "grad_norm_rel": abs(norm_g - norm_c) / abs(norm_c),
           "params": _scaled_max(card.params, cpu.params), "bn_state": _scaled_max(card.state, cpu.state),
           "opt_nu": _scaled_max(card.opt_state["nu"], cpu.opt_state["nu"]), "cpu_s": s_c, "card_s": s_g,
           "grad_norm_tol": norm_tol, "params_tol": param_tol, "card_spread": spreads}
    log(f"train step, card vs CPU ({what} at {IMAGE_SIZE}, f32, TF32 off, batch {batch}, lr {float(lr_fn(0)):.4g}): "
        f"loss {loss_g:.7f} / {loss_c:.7f} (rel {res['loss_rel']:.2e}, tol {TRAIN_LOSS_TOL}), grad norm {norm_g:.6f} / "
        f"{norm_c:.6f} (rel {res['grad_norm_rel']:.2e}, tol {norm_tol:.2e}); |diff|/(1+|x|): params "
        f"{res['params']:.2e} (tol {param_tol:.2e}), BN state {res['bn_state']:.2e}, nu {res['opt_nu']:.2e}; "
        f"step {s_g:.2f} s on the card (first), {s_c:.2f} s on the CPU"
        + ("" if spreads is None else "; each device's own spread, " + ", ".join(
            f"{tag}: grad norm rel {v['grad_norm_rel']:.2e}, params {v['params']:.2e}" for tag, v in spreads.items())
           + f" (tols: the larger of TRAIN_*_TOL and {SEARCH_SPREAD_FACTOR}x these)"))
    if (res["loss_rel"] > TRAIN_LOSS_TOL or res["grad_norm_rel"] > norm_tol or res["params"] > param_tol
            or not np.isfinite(loss_g)):
        raise AssertionError(f"the card's train step of {what} differs from the CPU path's: {res}")
    return res


def _record_syncs(run):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``: returns
    its result and every synchronizing CUDA call's (message, stack of
    function names)."""
    import traceback
    import warnings

    import torch

    syncs: list = []

    def record(message, category, filename, lineno, file=None, line=None):
        syncs.append((str(message)[:80], [f.name for f in traceback.extract_stack()]))

    mode = torch.cuda.get_sync_debug_mode()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    return out, syncs


def phase_train_run(device, tmp: str) -> tuple[dict, object, object]:
    """The shipped config through cli/train.py (``train()``: ``run()`` that
    also returns the state), TRAIN_STEPS steps at batch TRAIN_BATCH, with
    every synchronizing CUDA call recorded with its stack."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise

    cfg = _train_cfg(tmp, "shipped", f"data.fake_train_size={TRAIN_BATCH * TRAIN_STEPS}", "train.epochs=1",
                     f"train.log_every={TRAIN_LOG_EVERY}")
    if cfg.train.batch_size != TRAIN_BATCH or cfg.train.compute_dtype != "bfloat16":
        raise AssertionError(f"the shipped config changed: batch {cfg.train.batch_size}, {cfg.train.compute_dtype}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fused_depthwise.launches = 0
    t0 = time.perf_counter()
    (summary, ts, net), syncs = _record_syncs(lambda: train_cli.train(cfg, device=str(device)))
    wall = time.perf_counter() - t0
    k1 = fused_depthwise.launches
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    in_step = [(msg, stack) for msg, stack in syncs if "_one_step" in stack]
    sites: dict = {}
    for msg, stack in syncs:
        where = next((name for name in reversed(stack) if name in ("_log_point", "evaluate", "_train", "train")),
                     "?")
        sites[where] = sites.get(where, 0) + 1
    res = {k: v for k, v in summary.items() if k != "log"}
    res.update(wall_s=wall, peak_allocated_gb=peak_gb, syncs=len(syncs), sync_sites=sites,
               syncs_in_a_step=len(in_step), k1_launches=k1,
               losses=[row["loss"] for row in summary["log"]])
    log(f"train run (cli/train.py, apps/mobilenet_v3_large.yml: bf16, batch {TRAIN_BATCH}, TF RMSProp, EMA; fake "
        f"data): {summary['steps']} steps (counter {summary['step']}), {summary['finite_steps']} finite, on "
        f"{summary['device']}; log-point losses {[round(v, 4) for v in res['losses']]}; EMA eval top-1 "
        f"{summary['eval_top1']:.4f} loss {summary['eval_loss']:.4f} over {summary['eval_n']}; {wall:.1f} s "
        f"(set-up, {summary['seconds']:.1f} s of steps and eval); peak allocated {peak_gb:.2f} GB; synchronizing "
        f"calls {len(syncs)} by site {sites}, {len(in_step)} inside a step; K1 launches {k1}")
    if (summary["finite_steps"] != TRAIN_STEPS or summary["steps"] != TRAIN_STEPS or summary["step"] != TRAIN_STEPS
            or not summary["device"].startswith("cuda")):
        raise AssertionError(f"train run: {res}")
    if in_step:
        raise AssertionError(f"train run: {len(in_step)} host syncs inside a step, e.g. {in_step[0]}")
    if k1:
        raise AssertionError(f"train run: K1 launched {k1} times on the training path")
    return res, ts, net


def phase_overfit(device, tmp: str) -> dict:
    """OVERFIT_STEPS steps of the shipped config on one repeated batch at a
    constant LR (tests/test_train.py's overfit test at full size)."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

    cfg = _train_cfg(tmp, "overfit", "schedule.schedule=constant", "schedule.scale_by_batch=false",
                     f"schedule.base_lr={OVERFIT_LR}", "schedule.warmup_epochs=0")
    net = get_model(cfg.model, IMAGE_SIZE)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, OVERFIT_BATCH, 1, 1)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0])
    ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(0), device=device)
    step = steps.make_train_step(net, cfg, opt, lr_fn)
    gen = torch.Generator(device=device).manual_seed(3)
    batch = {"image": torch.randn((OVERFIT_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), generator=gen, device=device),
             "label": torch.arange(OVERFIT_BATCH, device=device, dtype=torch.int32) % 4}
    losses = []
    for _ in range(OVERFIT_STEPS):
        ts, m = step(ts, batch, gen)
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    factor = losses[-1] / losses[0]
    log(f"overfit ({OVERFIT_STEPS} steps on one batch of {OVERFIT_BATCH}, bf16, constant lr {OVERFIT_LR}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ({factor:.3f}x, gate < {OVERFIT_FACTOR}); "
        f"every 5th: {[round(v, 3) for v in losses[::5]]}")
    if not factor < OVERFIT_FACTOR:
        raise AssertionError(f"overfit: the loss fell only to {factor:.3f}x of its first value")
    return {"losses": losses, "factor": factor}


def phase_export_serve(device, tmp: str, ts, net, per_forward: int) -> dict:
    """The trained EMA weights through export_bundle (a float32 bundle) into
    the engine on the card: its logits against Network.apply(train=False) of
    the same weights on the card, within FOLD_ATOL, and K1's launches in
    SERVED_FORWARDS served forwards on the card's own counter, the graph's
    captured launches x replays."""
    tf32_off("the served logits against Network.apply at FOLD_ATOL")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree, unflatten_tree
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle

    def cpu(tree):
        return unflatten_tree({k: v.detach().cpu() for k, v in flatten_tree(tree).items()})

    bundle_dir = export_bundle(net, cpu(ts.ema_params), cpu(ts.ema_state), os.path.join(tmp, "trained"),
                               model_name="mobilenet_v3_large_trained", device=str(device))
    engine = InferenceEngine(load_bundle(bundle_dir), device=str(device), buckets=(TRAIN_CHECK_BATCH,))
    engine.warmup()
    (graph,) = engine.graph_report()
    if graph["k1_launches"] != per_forward:
        raise AssertionError(f"the served graph of the trained weights holds {graph['k1_launches']} K1 launches")
    x = np.random.RandomState(5).normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    card0 = _k1_on_card()
    for _ in range(SERVED_FORWARDS):
        got = engine.predict(x)
    k1 = _k1_card_gate(card0, per_forward * SERVED_FORWARDS,
                       f"{SERVED_FORWARDS} served forwards of the trained weights")
    with torch.inference_mode():
        want = net.apply(ts.ema_params, ts.ema_state, torch.from_numpy(x).to(device)).cpu().numpy()
    err = float(np.abs(got - want).max())
    log(f"train -> export -> serve: the engine's logits (f32, bucket {TRAIN_CHECK_BATCH}) vs Network.apply of the "
        f"EMA weights on the card: max |err| {err:.3e} (atol {FOLD_ATOL}), max |logit| "
        f"{float(np.abs(want).max()):.3e}; "
        f"K1 {k1} launches in {SERVED_FORWARDS} forwards (the card's own counter), {graph['k1_launches']} captured "
        f"in the graph")
    if got.shape != want.shape or not np.isfinite(got).all() or err > FOLD_ATOL:
        raise AssertionError(f"served logits of the trained weights differ by {err:.3e}")
    return {"max_abs_err": err, "k1_launches": k1 // SERVED_FORWARDS, "max_logit": float(np.abs(want).max())}


def phase_train_timing(device, tmp: str) -> dict:
    """ms per step (synchronized) and images/s of the trainer's step (with
    its device-side data) in bf16 and f32 at TRAIN_BATCH, peak memory, then
    PROFILED_STEPS bf16 steps under torch.profiler, and the optimizer update
    with EMA timed alone by CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from yet_another_mobilenet_series_tpu_torch.bench.trace_ops import kernel_kind
    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.data import pipeline
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree, unflatten_tree
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.train import ema as ema_lib, optim
    from yet_another_mobilenet_series_tpu_torch.utils.device import set_tf32

    out: dict = {}
    fake = None
    for dtype in ("bfloat16", "float32"):
        # TF32 as cli/train.py sets it for this dtype (off in float32)
        tf32 = set_tf32(dtype)
        cfg = _train_cfg(tmp, "timing_" + dtype, f"train.compute_dtype={dtype}")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, fake_num_classes=cfg.model.num_classes))
        net = get_model(cfg.model, IMAGE_SIZE)
        trainer = train_cli.Trainer(cfg, net, device)
        fake = fake or pipeline.FakeImages(cfg.data, device)
        batches = fake.train_batches(TRAIN_BATCH, 0)
        gen = torch.Generator(device=device).manual_seed(0)
        ts = trainer.init_state(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for _ in range(3):
            ts, m = trainer.train_step(ts, next(batches), gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMING_STEPS):
            ts, m = trainer.train_step(ts, next(batches), gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TIMING_STEPS * 1e3
        row = {"ms_per_step": ms, "images_per_s": TRAIN_BATCH / ms * 1e3, **tf32,
               "peak_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9, "loss": float(m["loss"])}
        if dtype == "bfloat16":
            fused_depthwise.launches = 0
            torch.cuda.synchronize()
            card0 = _k1_on_card()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILED_STEPS):
                    ts, m = trainer.train_step(ts, next(batches), gen)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            kernels = _device_kernels(prof)
            busy = sum(us for _, us, _ in kernels)
            opt_us = sum(us for name, us, _ in kernels if "multi_tensor_apply" in name)
            k1_profiled = _profiled_k1(prof)
            # the training forward has no folded stage: K1 runs nowhere in a step
            k1_dev = _k1_card_gate(card0, fused_depthwise.launches, f"{PROFILED_STEPS} bf16 train steps", k1_profiled)
            shares: dict = {}
            for name, us, _ in kernels:
                shares[kernel_kind(name)] = shares.get(kernel_kind(name), 0.0) + us / busy
            row["profile"] = {"wall_us": wall_us, "device_us": busy, "busy_share": busy / wall_us,
                              "multi_tensor_apply_us": opt_us, "multi_tensor_apply_share": opt_us / busy,
                              "kernel_launches": sum(c for _, _, c in kernels), "k1_device_count": k1_dev,
                              "k1_profiled": k1_profiled,
                              "shares_by_kind": shares,
                              "top": [{"kernel": n[:120], "device_us": us, "count": c} for n, us, c in kernels[:12]]}
            # the optimizer update + EMA alone, on gradients shaped like the params
            flat = flatten_tree(ts.params)
            grads = unflatten_tree({k: torch.randn_like(v) * 1e-2 for k, v in flat.items()})

            def update():
                upd, new_opt = trainer.optimizer.update(grads, ts.opt_state, ts.params)
                new_p = optim.apply_updates(ts.params, upd)
                ema_lib.ema_update(cfg.ema, ts.ema_params, new_p, ts.step)
                ema_lib.ema_update(cfg.ema, ts.ema_state, ts.state, ts.step)

            row["optimizer_ema_ms"] = cuda_time_ms(update, iters=20)
            row["optimizer_ema_device_ms"] = device_time_ms(update, iters=20)
            row["optimizer_ema_share"] = row["optimizer_ema_ms"] / ms
            if k1_dev or fused_depthwise.launches:
                raise AssertionError(f"K1 ran in a train step: {k1_dev} on the device, {fused_depthwise.launches}")
        out[dtype] = row
        log(f"train step timing ({dtype}, batch {TRAIN_BATCH}, MobileNetV3-Large 1.0 at {IMAGE_SIZE}, step with its "
            f"device-side data, TF32 {tf32['tf32_cudnn']}): {ms:.2f} ms per step synchronized, "
            f"{row['images_per_s']:.0f} images/s, peak "
            f"allocated {row['peak_allocated_gb']:.2f} GB")
        del trainer, ts, m, batches
        torch.cuda.empty_cache()
    p = out["bfloat16"]["profile"]
    log(f"profile, {PROFILED_STEPS} bf16 steps: device busy {p['device_us'] / 1e3:.2f} ms of {p['wall_us'] / 1e3:.2f} "
        f"ms wall ({100 * p['busy_share']:.1f}%), {p['kernel_launches'] // PROFILED_STEPS} kernels a step; "
        f"multi_tensor_apply (optimizer + EMA) {100 * p['multi_tensor_apply_share']:.2f}% of device time; the "
        f"update + EMA alone {out['bfloat16']['optimizer_ema_ms']:.3f} ms back to back (host-paced), "
        f"{out['bfloat16']['optimizer_ema_device_ms']:.3f} ms on the device alone "
        f"({100 * out['bfloat16']['optimizer_ema_share']:.2f}% of a step back to back); K1 {p['k1_device_count']} "
        f"launches on the card's own counter (the profiler kept {p['k1_profiled']}); device time by kind: "
        + ", ".join(f"{k} {100 * v:.1f}%" for k, v in sorted(p["shares_by_kind"].items(), key=lambda kv: -kv[1])))
    for row in p["top"][:10]:
        log(f"  {row['device_us'] / PROFILED_STEPS / 1e3:8.3f} ms/step  x{row['count'] // PROFILED_STEPS:<5d} "
            f"{row['kernel'][:100]}")
    return out


def _search_cfg(tmp: str, tag: str, *overrides: str):
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    return parse_cli([f"app:{SEARCH_APP}", "dist.num_devices=1", "data.dataset=fake", f"data.image_size={IMAGE_SIZE}",
                      f"train.log_dir={os.path.join(tmp, 'search_' + tag)}", *overrides])


def phase_search_parity(device, tmp: str) -> dict:
    """One f32 search step of the supernet at batch TRAIN_CHECK_BATCH, with
    the penalty, then one prune event, on the card and on the port's CPU
    path from one state and batch, and once more on the card with cuDNN off
    (PyTorch's native convolutions): loss and penalty at TRAIN_LOSS_TOL, the
    masks after the event equal, grad norm and params at the larger of
    TRAIN_*_TOL and SEARCH_SPREAD_FACTOR times the card's cuDNN-vs-native
    spread. Every PARITY_DEAD_EVERY-th gamma of each prunable block starts
    at 0.01, below PARITY_GAMMA_THRESHOLD, so the event has deaths to agree
    on."""
    tf32_off("one float32 search step, card against CPU")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.nas import masking, penalty
    from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

    cfg = _search_cfg(tmp, "parity", "train.compute_dtype=float32", "model.dropout=0.0", "schedule.warmup_epochs=0",
                      "prune.mask_interval=1", "prune.target_flops=0",
                      f"prune.gamma_threshold={PARITY_GAMMA_THRESHOLD}")
    net = get_model(cfg.model, IMAGE_SIZE)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, TRAIN_CHECK_BATCH, 1, 1)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0])
    rng = np.random.RandomState(2)
    x = rng.normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    y = (np.arange(TRAIN_CHECK_BATCH) * 37 % cfg.model.num_classes).astype(np.int32)
    runs = []
    try:
        for dev, cudnn in ((torch.device("cpu"), True), (device, True), (device, False)):
            torch.backends.cudnn.enabled = cudnn
            ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(0), device=dev)
            for k in ts.masks:
                ts.params["blocks"][k]["dw_bn"]["gamma"][::PARITY_DEAD_EVERY] = 0.01
            step = steps.make_train_step(net, cfg, opt, lr_fn,
                                         penalty_fn=penalty.make_penalty_fn(net, cfg.prune, 1, device=dev))
            event = masking.make_prune_event(net, cfg.prune, stop_step=1, device=dev)
            batch = {"image": torch.from_numpy(x).to(dev), "label": torch.from_numpy(y).to(dev)}
            new, m = step(ts, batch, torch.Generator(device=dev).manual_seed(0))
            masks, _ = event(new.params, new.masks, new.rho_mult, new.step)
            runs.append((new, float(m["loss"]), float(m["grad_norm"]), float(m["penalty"]),
                         {k: v.cpu() for k, v in masks.items()}))
    finally:
        torch.backends.cudnn.enabled = True
    (cpu, loss_c, norm_c, pen_c, masks_c), (card, loss_g, norm_g, pen_g, masks_g), native = runs
    spread = {"grad_norm_rel": abs(native[2] - norm_g) / abs(norm_g), "params": _scaled_max(native[0].params,
                                                                                            card.params)}
    norm_tol = max(TRAIN_NORM_TOL, SEARCH_SPREAD_FACTOR * spread["grad_norm_rel"])
    param_tol = max(TRAIN_PARAM_TOL, SEARCH_SPREAD_FACTOR * spread["params"])
    alive = int(sum(float(v.sum()) for v in masks_g.values()))
    total = sum(v.numel() for v in masks_g.values())
    res = {"loss_rel": abs(loss_g - loss_c) / abs(loss_c), "grad_norm_rel": abs(norm_g - norm_c) / abs(norm_c),
           "penalty_card": pen_g, "penalty_cpu": pen_c, "penalty_rel": abs(pen_g - pen_c) / abs(pen_c),
           "params": _scaled_max(card.params, cpu.params), "opt_nu": _scaled_max(card.opt_state["nu"],
                                                                                 cpu.opt_state["nu"]),
           "masks_equal": all(torch.equal(masks_c[k], masks_g[k]) for k in masks_c),
           "alive_atoms": alive, "total_atoms": total, "card_spread": spread, "grad_norm_tol": norm_tol,
           "params_tol": param_tol, "grad_norm": norm_c}
    log(f"search step + prune event, card vs CPU (atomnas_supernet 1.0 at {IMAGE_SIZE}, f32, TF32 off, batch "
        f"{TRAIN_CHECK_BATCH}): loss rel {res['loss_rel']:.2e} (tol {TRAIN_LOSS_TOL}), grad norm {norm_c:.4f}, rel "
        f"{res['grad_norm_rel']:.2e} (tol {norm_tol:.2e}), penalty {pen_g:.6e} / {pen_c:.6e} (rel "
        f"{res['penalty_rel']:.2e}), params {res['params']:.2e} (tol {param_tol:.2e}), nu {res['opt_nu']:.2e}; "
        f"the card's cuDNN vs native convolutions: grad norm rel {spread['grad_norm_rel']:.2e}, params "
        f"{spread['params']:.2e} (tols: the larger of TRAIN_*_TOL and {SEARCH_SPREAD_FACTOR}x these); masks after "
        f"the event equal: {res['masks_equal']} ({alive}/{total} atoms alive)")
    if (res["loss_rel"] > TRAIN_LOSS_TOL or res["grad_norm_rel"] > norm_tol or res["params"] > param_tol
            or res["penalty_rel"] > TRAIN_LOSS_TOL or not res["masks_equal"] or not 0 < alive < total):
        raise AssertionError(f"the card's search step differs from the CPU path's: {res}")
    return res


def _time_train_steps(trainer, cfg, device, fake) -> dict:
    """ms per step (synchronized, the step with its device-side data),
    images/s and peak memory of a trainer's step at cfg's batch."""
    import torch

    batches = fake.train_batches(cfg.train.batch_size, 0)
    gen = torch.Generator(device=device).manual_seed(0)
    ts = trainer.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for _ in range(2):
        ts, m = trainer.train_step(ts, next(batches), gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SEARCH_TIMING_STEPS):
        ts, m = trainer.train_step(ts, next(batches), gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / SEARCH_TIMING_STEPS * 1e3
    return {"ms_per_step": ms, "images_per_s": cfg.train.batch_size / ms * 1e3,
            "peak_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9, "loss": float(m["loss"])}


def phase_search_run(device, tmp: str) -> tuple[dict, object, object, object]:
    """The search through cli/train.py (``train()``: ``run()`` that also
    returns the state): apps/atomnas_a_search.yml at full width with the
    cuts of the SEARCH_* constants, every synchronizing CUDA call recorded
    with its stack. Then the step of the supernet and of the searched
    network timed alone, bf16 at SEARCH_BATCH."""
    import dataclasses as dc

    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.data import pipeline
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.utils.profiling import profile_network

    cuts = [f"train.batch_size={SEARCH_BATCH}", f"data.fake_train_size={SEARCH_BATCH * SEARCH_STEPS_PER_EPOCH}",
            f"data.fake_eval_size={SEARCH_EVAL_IMAGES}", f"train.eval_batch_size={SEARCH_BATCH}",
            f"train.epochs={SEARCH_EPOCHS}", f"train.log_every={SEARCH_LOG_EVERY}",
            f"prune.mask_interval={SEARCH_MASK_INTERVAL}", f"prune.remat_epochs={SEARCH_REMAT_EPOCHS}",
            f"prune.gamma_threshold={SEARCH_GAMMA_THRESHOLD}"]
    cfg = _search_cfg(tmp, "run", *cuts)
    supernet = get_model(cfg.model, IMAGE_SIZE)
    super_macs = profile_network(supernet).total_macs
    rebuilds0 = get_registry().snapshot().get("train.rebuilds", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fused_depthwise.launches = 0
    t0 = time.perf_counter()
    (summary, ts, net), syncs = _record_syncs(lambda: train_cli.train(cfg, device=str(device)))
    wall = time.perf_counter() - t0
    k1 = fused_depthwise.launches
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    rebuilds = get_registry().snapshot().get("train.rebuilds", 0) - rebuilds0
    in_step = [(msg, st) for msg, st in syncs if "_one_step" in st]
    in_event = [(msg, st) for msg, st in syncs if "_prune_event" in st]
    sites: dict = {}
    for msg, st in syncs:
        where = next((name for name in reversed(st) if name in (
            "_log_point", "evaluate", "remat_point", "_write_searched", "_train", "train")), "?")
        sites[where] = sites.get(where, 0) + 1
    remats = summary["remats"]
    searched = summary["searched"]
    total_steps = SEARCH_STEPS_PER_EPOCH * SEARCH_EPOCHS
    res = {k: v for k, v in summary.items() if k != "log"}
    res.update(cuts=cuts, wall_s=wall, peak_allocated_gb=peak_gb, syncs=len(syncs), sync_sites=sites,
               syncs_in_a_step=len(in_step), syncs_in_an_event=len(in_event), rebuilds=rebuilds, k1_launches=k1,
               supernet_macs=super_macs, log=[{k: row[k] for k in ("step", "loss", "penalty", "effective_macs")}
                                              for row in summary["log"]])
    log(f"search run (cli/train.py, apps/atomnas_a_search.yml: atomnas_supernet 1.0 at {IMAGE_SIZE}, relu6, bf16, "
        f"TF RMSProp, EMA, rho {cfg.prune.rho}, target {cfg.prune.target_flops / 1e6:.0f}M MACs; fake data; cut: "
        f"dist.num_devices=1 (SyncBN over one device is exact BN), {' '.join(cuts)} — the threshold raised so that "
        f"atoms die in a run this short): {summary['steps']} steps (counter {summary['step']}), "
        f"{summary['finite_steps']} finite, on {summary['device']}; log points "
        + ", ".join(f"step {r['step']} loss {r['loss']:.4f} penalty {r['penalty']:.3e} effective "
                    f"{r['effective_macs'] / 1e6:.1f}M" for r in res["log"])
        + f"; EMA eval top-1 {summary['eval_top1']:.4f} over {summary['eval_n']}; {wall:.1f} s; peak allocated "
        f"{peak_gb:.2f} GB; synchronizing calls {len(syncs)} by site {sites}, {len(in_step)} inside a step, "
        f"{len(in_event)} inside a prune event; train.rebuilds {rebuilds}; K1 launches {k1}")
    for r in remats:
        log(f"  rematerialize at step {r['step']}: atoms {r['atoms_before']} -> {r['atoms_after']}, dropped blocks "
            f"{r['dropped_blocks']}, MACs {r['macs_before'] / 1e6:.1f}M -> {r['macs_after'] / 1e6:.1f}M, device "
            f"memory allocated {r['memory_allocated_before'] / 1e9:.3f} -> {r['memory_allocated_after'] / 1e9:.3f} GB")
    log(f"  searched_arch.json: MACs {super_macs / 1e6:.1f}M (supernet) -> {searched['macs'] / 1e6:.1f}M, "
        f"{searched['params'] / 1e6:.3f}M params, step {searched['step']}")
    if (summary["steps"] != total_steps or summary["finite_steps"] != total_steps or summary["step"] != total_steps
            or not summary["device"].startswith("cuda")):
        raise AssertionError(f"search run: {res}")
    if not remats or remats[0]["step"] >= total_steps or remats[0]["atoms_after"] >= remats[0]["atoms_before"]:
        raise AssertionError(f"search run: no rematerialization mid-run with dead atoms: {remats}")
    if rebuilds != len(remats) or searched["macs"] >= super_macs or searched["step"] != total_steps:
        raise AssertionError(f"search run: rebuilds {rebuilds}, searched {searched}")
    if remats[0]["memory_allocated_after"] >= remats[0]["memory_allocated_before"]:
        raise AssertionError(f"search run: the supernet's memory was not freed: {remats[0]}")
    if in_step or in_event:
        raise AssertionError(f"search run: host syncs inside a step ({len(in_step)}) or an event ({len(in_event)}): "
                             f"{(in_step + in_event)[0]}")
    if k1:
        raise AssertionError(f"search run: K1 launched {k1} times on the training path")

    # the step of the supernet and of the searched network alone (bf16)
    tcfg = dc.replace(cfg, data=dc.replace(cfg.data, fake_num_classes=cfg.model.num_classes))
    fake = pipeline.FakeImages(tcfg.data, device)
    timing = {}
    for tag, tnet in (("supernet", supernet), ("searched", net)):
        timing[tag] = _time_train_steps(train_cli.Trainer(tcfg, tnet, device), tcfg, device, fake)
        torch.cuda.empty_cache()
    del fake
    res["timing"] = timing
    log(f"search step timing (bf16, batch {SEARCH_BATCH}, with the penalty, step with its device-side data): "
        + "; ".join(f"{tag} {r['ms_per_step']:.2f} ms per step, {r['images_per_s']:.0f} images/s, peak "
                    f"{r['peak_allocated_gb']:.2f} GB" for tag, r in timing.items()))
    return res, ts, net, supernet


def _dead_masks(net, seed: int) -> dict:
    """Random masks of ``net``'s prunable blocks (about 40% dead), a
    residual block dead whole and, in another block, a whole branch."""
    import numpy as np

    from yet_another_mobilenet_series_tpu_torch.nas.masking import prunable_blocks

    rng = np.random.RandomState(seed)
    blocks = prunable_blocks(net)
    masks = {str(i): (rng.uniform(size=net.blocks[i].expanded_channels) > 0.4).astype(np.float32) for i in blocks}
    residual = next(i for i in blocks if net.blocks[i].has_residual)
    masks[str(residual)][:] = 0.0
    other = next(i for i in blocks if i != residual and len(net.blocks[i].kernel_sizes) > 1)
    off, g = net.blocks[other].group_channels[0], net.blocks[other].group_channels[1]
    masks[str(other)][off: off + g] = 0.0  # its second branch
    masks[str(other)][0] = 1.0
    return masks


def phase_masked_vs_remat(device, tmp: str, supernet) -> dict:
    """On the card: the supernet's eval forward under dead masks against
    the rematerialized network's (sliced on the card), f32, TF32 off, at the
    f32 bar; then export_bundle with the same masks, whose spec must be the
    rematerialized one."""
    tf32_off("masked against rematerialized forward at the float32 bar")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree, unflatten_tree
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.nas import rematerialize
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle
    from yet_another_mobilenet_series_tpu_torch.utils.profiling import masked_macs, profile_network

    def to(tree, dev):
        return unflatten_tree({k: v.to(dev) for k, v in flatten_tree(tree).items()})

    gen = torch.Generator().manual_seed(5)
    params, _ = supernet.init(gen)
    state = random_bn_state(supernet, gen)
    np_masks = _dead_masks(supernet, 6)
    masks = {k: torch.from_numpy(v).to(device) for k, v in np_masks.items()}
    p, s = to(params, device), to(state, device)
    x = torch.from_numpy(np.random.RandomState(7).normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3))
                         .astype(np.float32)).to(device)
    new_net, new_p, new_s, _, _, report = rematerialize.rematerialize(supernet, p, s, masks)
    with torch.inference_mode():
        masked = supernet.apply(p, s, x, masks={int(k): v for k, v in masks.items()}).cpu().numpy()
        rebuilt = new_net.apply(new_p, new_s, x).cpu().numpy()
    err = float(np.abs(rebuilt - masked).max())
    ok = np.all(np.abs(rebuilt - masked) <= SLICE_ATOL + SLICE_RTOL * np.abs(masked)) and np.isfinite(rebuilt).all()
    eff = masked_macs(supernet, {int(k): v for k, v in np_masks.items()})
    bundle = load_bundle(export_bundle(supernet, params, state, os.path.join(tmp, "masked_bundle"), masks=masks,
                                       device=str(device)))
    res = {"max_abs_err": err, "max_logit": float(np.abs(masked).max()), "atoms_before": report.atoms_before,
           "atoms_after": report.atoms_after, "dropped_blocks": report.dropped_blocks,
           "dropped_branches": {str(k): v for k, v in report.dropped_branches.items()},
           "masked_macs": eff, "rematerialized_macs": profile_network(new_net).total_macs,
           "bundle_prune": bundle.meta.get("prune")}
    log(f"masked vs rematerialized forward on the card (supernet 1.0 at {IMAGE_SIZE}, f32, batch "
        f"{TRAIN_CHECK_BATCH}; atoms {report.atoms_before} -> {report.atoms_after}, dropped blocks "
        f"{report.dropped_blocks}, dropped branches {report.dropped_branches}): max |err| {err:.3e}, max |logit| "
        f"{res['max_logit']:.3e} (atol {SLICE_ATOL}, rtol {SLICE_RTOL}); masked MACs {eff / 1e6:.2f}M = rebuilt "
        f"{res['rematerialized_macs'] / 1e6:.2f}M; the dead-mask bundle's spec is the rebuilt one: "
        f"{bundle.net.blocks == new_net.blocks}")
    if not ok or abs(eff - res["rematerialized_macs"]) > 1e-6 * eff or bundle.net.blocks != new_net.blocks \
            or not report.dropped_blocks or not report.dropped_branches:
        raise AssertionError(f"masked vs rematerialized forward: {res}")
    return res


def net_branch_stages(net, batch: int) -> list[tuple]:
    """(block, n, h, expanded, offset, channels, k, stride, act) of every
    depthwise branch of ``net`` at IMAGE_SIZE, in forward order: the channel
    slices the folded forward runs K1 on."""
    h = (IMAGE_SIZE - 1) // net.stem.stride + 1
    out = []
    for i, blk in enumerate(net.blocks):
        for _, k, g, off in blk._branches():
            out.append((i, batch, h, blk.expanded_channels, off, g, k, blk.stride, blk.active_fn))
        h = (h - 1) // blk.stride + 1
    return out


def check_net_stages(device, nets: dict, batches=(1, 32)) -> dict:
    """K1 against its plain version at every depthwise branch of each net,
    as the folded forward launches it: the branch's channel slice of one
    wide NHWC tensor written in place into a slice of one wide output (the
    supernet's block 0: 32 channels at 112x112 in branches of 11/11/10; k=7
    at every stage), f32 and bf16, at each batch."""
    tf32_off("the kernel against its plain version at the float32 bar")
    import torch

    from yet_another_mobilenet_series_tpu_torch.ops import fused_depthwise as fdw

    gen = torch.Generator(device=device).manual_seed(8)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    failures, count, scalar = [], 0, 0
    with torch.inference_mode():
        for tag, net in nets.items():
            for batch in batches:
                by_block: dict = {}
                for stage in net_branch_stages(net, batch):
                    by_block.setdefault(stage[0], []).append(stage)
                for stages in by_block.values():
                    _, n, h, e, _, _, _, s, act = stages[0]
                    for dtype in (torch.float32, torch.bfloat16):
                        x = torch.randn((n, h, h, e), generator=gen, device=device).to(dtype)
                        out = torch.full(((n, (h - 1) // s + 1, (h - 1) // s + 1, e)), float("nan"), device=device,
                                         dtype=dtype)
                        for (blk, _, _, _, off, g, k, _, _) in stages:
                            ops = kernel_operands(n, h, g, k, dtype, gen, device)[1:]
                            xs, ys = x[..., off: off + g], out[..., off: off + g]
                            scalar += fdw.launch_plan(xs, k, s, ys).vec == 1
                            fdw.fused_depthwise(xs, *ops, s, act, out=ys)
                            torch.cuda.synchronize()
                            ref = fdw.fused_depthwise_reference(xs.contiguous(), *ops, s, act)
                            tol = (F32_TOL, F32_TOL) if dtype == torch.float32 else (BF16_ATOL, BF16_RTOL)
                            err, ok = compare(ys, ref, *tol)
                            errs[dtype] = max(errs[dtype], err)
                            count += 1
                            if not ok:
                                failures.append((tag, batch, blk, off, g, k, s, str(dtype), err))
                        if torch.isnan(out.float()).any():
                            failures.append((tag, batch, stages[0][0], "a channel left unwritten"))
    counts = ", ".join(f"{t}: {len(net_branch_stages(n, 1))} branches" for t, n in nets.items())
    log(f"K1 vs plain at the branches of ({counts}; "
        f"batches {'/'.join(map(str, batches))}; channel slices in place, {scalar} of {count} launches on the "
        f"scalar path): max |err| f32 {errs[torch.float32]:.3e} (tol {F32_TOL}), bf16 {errs[torch.bfloat16]:.3e} "
        f"(atol {BF16_ATOL}, rtol {BF16_RTOL:.4g})")
    if failures:
        raise AssertionError(f"K1 disagrees with its plain version at the branches of {list(nets)}: {failures[:5]}")
    return {"cases": count, "scalar_launches": scalar, "max_f32": errs[torch.float32],
            "max_bf16": errs[torch.bfloat16]}


def profile_served_forwards(engine, x, per_forward: int, what: str) -> dict:
    """SERVED_FORWARDS forwards of ``x`` through ``engine`` (warm, one graph
    key) in each of two torch.profiler windows (``_profiled_windows``): K1's
    launches in each on the card's own counter, held to ``per_forward`` a
    forward, and as the profiler kept them; the second window's K1 device
    time and all kernels' count and device time (K1's share of a forward)."""
    prof, seen, card, _ = _profiled_windows(lambda: engine.predict(x), SERVED_FORWARDS)
    for i, (n_card, n_seen) in enumerate(zip(card, seen)):
        _k1_check(n_card, per_forward * SERVED_FORWARDS, f"{what}, profiler window {i + 1}", n_seen)
    kernels = _device_kernels(prof)
    return {"k1": card[1], "k1_profiled": seen[1], "k1_discarded_window": card[0],
            "k1_profiled_discarded_window": seen[0],
            "k1_us": sum(us for name, us, _ in kernels if "fused_dw_kernel" in name),
            "kernels": sum(c for _, _, c in kernels), "busy_us": sum(us for _, us, _ in kernels)}


def phase_search_serve(device, tmp: str, ts, net) -> dict:
    """The searched network's EMA weights through export_bundle into the
    port's serving entry point, ``cli/serve.py``'s ``run(cfg, device)``
    (the shipped serving config: buckets 1/8/32, f32), the counts at 0 just
    before and read just after; then an engine of the bundle: its logits
    against Network.apply of the same weights on the card within FOLD_ATOL,
    and K1's launches per forward on the card's own counter equal to the
    searched network's surviving branches, K1's share of the forwards'
    device time from the profiler (``profile_served_forwards``)."""
    tf32_off("the served logits against Network.apply at FOLD_ATOL")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree, unflatten_tree
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle

    def cpu(tree):
        return unflatten_tree({k: v.detach().cpu() for k, v in flatten_tree(tree).items()})

    per_forward = sum(1 for blk in net.blocks for _ in blk._branches())
    bundle_dir = export_bundle(net, cpu(ts.ema_params), cpu(ts.ema_state), os.path.join(tmp, "searched"),
                               masks=ts.masks, model_name="atomnas_a_searched", device=str(device))
    cfg = parse_cli([f"app:{APP}", f"serve.bundle={bundle_dir}", f"serve.requests={SEARCH_SERVE_REQUESTS}",
                     f"serve.clients={SERVE_CLIENTS}", "serve.compute_dtype=float32", f"data.image_size={IMAGE_SIZE}",
                     f"train.log_dir={os.path.join(tmp, 'log_searched')}"])
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    card0 = _k1_on_card()
    result = serve_cli.run(cfg, device=str(device))
    launches = fused_depthwise.launches
    k1 = _k1_accounting(result["graphs"], launches, per_forward)
    k1["card"] = _k1_card_gate(card0, k1["launches"], "the searched bundle through cli.serve.run")
    log(f"searched bundle (cli.serve.run, buckets {'/'.join(map(str, cfg.serve.buckets))}, f32): "
        f"{result['completed']}/{result['requests']} requests, {result['qps']:.1f} QPS, p50 {result['p50_ms']:.2f} "
        f"ms, p99 {result['p99_ms']:.2f} ms; {result['dispatches']} dispatches = {result['replays']} graph replays; "
        f"K1 {k1['launches']} launches = {k1['warm']} warm + {k1['replayed']} replayed ({per_forward} per forward, "
        f"one per surviving branch), {k1['card']} on the card's own counter")
    if result["completed"] != SEARCH_SERVE_REQUESTS or result["shed"] or result["rejected_full"] \
            or result["dispatches"] != result["replays"]:
        raise AssertionError(f"searched bundle: {result}")

    engine = InferenceEngine(load_bundle(bundle_dir), device=str(device), buckets=(TRAIN_CHECK_BATCH,))
    engine.warmup()
    x = np.random.RandomState(12).normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    got = engine.predict(x)
    prof = profile_served_forwards(engine, x, per_forward, f"{SERVED_FORWARDS} served forwards of the searched net")
    counted = prof["k1"]
    with torch.inference_mode():
        want = net.apply(ts.ema_params, ts.ema_state, torch.from_numpy(x).to(device)).cpu().numpy()
    err = float(np.abs(got - want).max())
    res = {"per_forward": per_forward, "k1": k1, "wrapper_launches": launches, "card_per_forward":
           counted // SERVED_FORWARDS, "profile": prof, "max_abs_err": err,
           "max_logit": float(np.abs(want).max()), "k1_share_of_device_time": prof["k1_us"] / prof["busy_us"],
           "qps": result["qps"], "p50_ms": result["p50_ms"], "p99_ms": result["p99_ms"]}
    log(f"searched bundle served vs Network.apply of the EMA weights on the card (f32, bucket {TRAIN_CHECK_BATCH}): "
        f"max |err| {err:.3e} (atol {FOLD_ATOL}), max |logit| {res['max_logit']:.3e}; K1 {counted} launches in "
        f"{SERVED_FORWARDS} forwards on the card's own counter (the profiler kept {prof['k1_profiled']}; the first "
        f"window {prof['k1_discarded_window']} / {prof['k1_profiled_discarded_window']}; {per_forward} surviving "
        f"branches; {prof['kernels']} kernels in all), {100 * res['k1_share_of_device_time']:.1f}% of the forwards' "
        f"device time")
    if got.shape != want.shape or not np.isfinite(got).all() or err > FOLD_ATOL:
        raise AssertionError(f"searched bundle's logits differ by {err:.3e}")
    return res


def phase_retrain(device, tmp: str, searched_path: str, net) -> dict:
    """apps/retrain_searched.yml with model.network_spec at the search's
    searched_arch.json, RETRAIN_STEPS steps through cli/train.py."""
    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    cuts = ["dist.num_devices=1", f"train.batch_size={RETRAIN_BATCH}",
            f"data.fake_train_size={RETRAIN_BATCH * RETRAIN_STEPS}", f"data.fake_eval_size={RETRAIN_BATCH}",
            f"train.eval_batch_size={RETRAIN_BATCH}", "train.epochs=1", f"train.log_every={RETRAIN_STEPS}"]
    cfg = parse_cli([f"app:{RETRAIN_APP}", f"model.network_spec={searched_path}", "data.dataset=fake",
                     f"data.image_size={IMAGE_SIZE}", f"train.log_dir={os.path.join(tmp, 'retrain')}", *cuts])
    summary, _, rnet = train_cli.train(cfg, device=str(device))
    res = {k: v for k, v in summary.items() if k != "log"}
    res["cuts"] = cuts
    log(f"retrain (cli/train.py, apps/retrain_searched.yml, model.network_spec=searched_arch.json; bf16; fake data; "
        f"cut: {' '.join(cuts)}): {summary['steps']} steps, {summary['finite_steps']} finite, loss "
        f"{summary['log'][-1]['loss']:.4f}, on {summary['device']}; the searched blocks: {rnet.blocks == net.blocks}")
    if summary["finite_steps"] != RETRAIN_STEPS or rnet.blocks != net.blocks or not summary["device"].startswith(
            "cuda"):
        raise AssertionError(f"retrain: {res}")
    return res


def _bench(module: str, *argv: str, timeout: int = BENCH_TIMEOUT_S) -> dict:
    """``python -m yet_another_mobilenet_series_tpu_torch.bench.<module>``
    from the repository root: its one JSON line, gated on exit 0, no
    ``error``, ``cuda``, this card's name, a power limit and the versions."""
    return _bench_finish(module, _bench_start(module, *argv), timeout)


def _bench_start(module: str, *argv: str):
    """The bench's process, started in a session of its own (its replicas
    are its children), its output into files that nothing has to drain
    while it runs (``_bench_finish`` waits for it and reads them)."""
    out_f, err_f = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", f"yet_another_mobilenet_series_tpu_torch.bench.{module}", *argv],
                            cwd=REPO, stdout=out_f, stderr=err_f, text=True, start_new_session=True)
    return proc, time.perf_counter(), out_f, err_f


def _bench_wait(started, timeout: float) -> tuple[str, str]:
    """The started bench's stdout and stderr once it has ended, within
    ``timeout`` seconds of its start; past it, its process group is
    killed and the timeout raised."""
    proc, t0, out_f, err_f = started
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        raise
    finally:
        out_f.seek(0)
        err_f.seek(0)
        stdout, stderr = out_f.read(), err_f.read()
        out_f.close()
        err_f.close()
    return stdout, stderr


def _bench_stop(started) -> None:
    """A started bench that has not ended (a phase beside it raised): its
    process group killed, its files closed."""
    _kill_group(started[0])
    for f in started[2:]:
        f.close()


def _bench_finish(module: str, started, timeout: int = BENCH_TIMEOUT_S) -> dict:
    proc, t0 = started[:2]
    stdout, stderr = _bench_wait(started, timeout)
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench {module} exited {proc.returncode} with {len(lines)} lines: "
                             f"{stdout[-2000:]} {stderr[-3000:]}")
    out = _gate_bench_line(module, json.loads(lines[0]))
    out["_seconds"] = time.perf_counter() - t0
    return out


def _gate_bench_line(module: str, out: dict) -> dict:
    """A bench's line: no ``error``, ``cuda``, this card's name, a power
    limit and the versions."""
    import torch

    prov = out["provenance"]
    if ("error" in out or out.get("platform") != "cuda" or prov["device_name"] != torch.cuda.get_device_name(0)
            or prov["cpu_rehearsal"] or not (prov["nvidia_smi"] or "").endswith(" W") or not prov["torch_version"]
            or not prov["cuda_version"]):
        raise AssertionError(f"bench {module}: {json.dumps(out)[:3000]}")
    return out


def _bench_here(module: str, *argv: str) -> dict:
    """The bench's ``main`` in this process (its cuDNN choices and the
    host library already made), its one stdout line gated as ``_bench``
    gates it."""
    import contextlib
    import importlib
    import io

    mod = importlib.import_module(f"yet_another_mobilenet_series_tpu_torch.bench.{module}")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"bench {module} returned {rc} with {len(lines)} lines: {buf.getvalue()[-3000:]}")
    out = _gate_bench_line(module, json.loads(lines[0]))
    out["_seconds"] = time.perf_counter() - t0
    return out


def phase_benches(device, tmp: str) -> dict:
    """The benches on the card at short lengths (docstring, item 9), each
    one's ``main`` in this process (``_bench_here``): the process, its CUDA
    context and cuDNN's choices at phase 7's and phase 8's shapes are made
    by then, so each bench pays its own work and not a new process's start.
    The serve bench's ``--zoo`` and ``--fleet`` arms run later, as processes
    of their own (``start_serve_arm``)."""
    import gc

    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.nas import penalty

    res: dict = {}
    trace = os.path.join(tmp, "train_bench_trace.json")
    tb = _bench_here("train_bench", "--batch", str(TRAIN_BATCH), "--steps", str(BENCH_TRAIN_STEPS), "--warmup", "2",
                     "--profile-steps", "2", "--trace-out", trace)
    if not (0 < (tb["mfu"] or 0) <= 1.05) or not 0 < tb["device_busy_share"] <= 1:
        raise AssertionError(f"train bench: mfu {tb['mfu']}, busy {tb['device_busy_share']}")
    log(f"train bench (bf16, batch {TRAIN_BATCH}, {tb['ms_per_step']['count']} steps): {tb['images_per_sec']:.0f} "
        f"images/s, {tb['ms_per_step']['median']:.2f} ms per step (median), peak {tb['peak_allocated_gb']:.2f} GB, "
        f"busy {100 * tb['device_busy_share']:.1f}%, MFU {100 * tb['mfu']:.3f}% of {tb['peak_flops'] / 1e12:.0f} "
        f"TFLOP/s ({tb['_seconds']:.1f} s)")
    res["train"] = tb
    to = _bench_here("trace_ops", trace, "--steps", "2", "--top", "10")
    if not to["device_events"] or abs(to["busy_share"] - tb["device_busy_share"]) > 1e-9:
        raise AssertionError(f"trace_ops: {to['busy_share']} against the bench's {tb['device_busy_share']}")
    log(f"trace_ops over the train bench's window: busy {100 * to['busy_share']:.1f}%, "
        f"{to['events_per_step']:.0f} device events a step; by kind "
        + ", ".join(f"{k} {100 * v['share']:.1f}%" for k, v in to["by_kind"].items()))
    res["trace_ops"] = to
    sb = _bench_here("serve_bench", "--iters", "5", "--rounds", "1", "--ab-iters", "3", "--fused-iters", "2",
                     "--structural-rounds", "1", "--quant-iters", "2", "--quant-rounds", "1",
                     "--chaos-requests", str(BENCH_CHAOS_REQUESTS), "--chaos-load", "0.5")
    bf16, k1 = sb["ab"]["bf16_vs_fp32"], sb["k1_launches"]
    rounds = sb["chaos"]["rounds"]
    if (not bf16["parity_ok"] or k1["per_forward"] != 15 or k1["replayed"] <= 0
            or any(r[k]["unresolved"] for r in rounds for k in ("healthy", "faulty"))
            or not sb["ab"]["structural_sweep"]["bitwise_ok"] or not sb["ab"]["structural_sweep"]["ring_probe"]["bitwise_ok"]
            or not all(r["bitwise_ok"] for r in sb["ab"]["fused_vs_chained"]["per_k"])
            or not sb["ab"]["quant"]["parity"]["identity_norm_bitwise"]):
        raise AssertionError(f"serve bench: {json.dumps(sb)[:4000]}")
    healthy = rounds[0]["healthy"]["classes"]["all"]
    log(f"serve bench (MobileNetV3-Large at 224, buckets 1/8/32): peak {sb['peak_qps']:.0f} QPS; bf16 max |logit "
        f"delta| {bf16['max_abs_logit_delta']:.2e} (bar {bf16['parity_atol']}); K1 {k1['total']} launches "
        f"({k1['replayed']} replayed, {k1['per_forward']} a forward); open loop at {rounds[0]['target_qps']:.0f} QPS: "
        f"{healthy['completed']} of {healthy['submitted']} completed, p50 {healthy['p50_ms']:.2f} ms, p99 "
        f"{healthy['p99_ms']:.2f} ms, unresolved 0 ({sb['_seconds']:.1f} s)")
    res["serve"] = sb
    table = os.path.join(tmp, "LATENCY_TABLE_supernet.json")
    lt = _bench_here("latency_table", "--app", SEARCH_APP, "--iters", "20", "--out", table)
    supernet = get_model(parse_cli([f"app:{SEARCH_APP}"]).model, IMAGE_SIZE)
    lat = [v for e in lt["entries"] for v in e["latency_s"]]
    if lt["value"] < 2 or min(lat) <= 0:
        raise AssertionError(f"latency table: {json.dumps(lt)[:3000]}")
    log(f"latency table of atomnas_supernet at {IMAGE_SIZE} (folded, K1, CUDA graphs, batch {lt['batch']}): "
        f"{lt['value']:.0f} entries, {1e6 * sum(e['latency_s'][-1] for e in lt['entries']):.2f} us an image over "
        f"the distinct blocks at full width ({lt['_seconds']:.1f} s)")
    res["latency_table"] = lt
    # a few steps of phase 8's search config, weighted by the table
    cuts = [f"train.batch_size={SEARCH_BATCH}", f"data.fake_train_size={SEARCH_BATCH * BENCH_SEARCH_STEPS}",
            f"data.fake_eval_size={SEARCH_BATCH}", f"train.eval_batch_size={SEARCH_BATCH}", "train.epochs=1",
            f"train.log_every={BENCH_SEARCH_STEPS}", f"prune.mask_interval={SEARCH_MASK_INTERVAL}",
            "prune.remat_epochs=1", f"prune.gamma_threshold={SEARCH_GAMMA_THRESHOLD}",
            "prune.cost=latency_table", f"prune.latency_table={table}"]
    cfg = _search_cfg(tmp, "latency", *cuts)
    flops = penalty.atom_cost_table(supernet, dataclasses.replace(cfg.prune, cost="flops"))
    by_table = penalty.atom_cost_table(supernet, cfg.prune)
    shares = [(np.asarray(flops[k]) / sum(np.sum(v) for v in flops.values()),
               np.asarray(by_table[k]) / sum(np.sum(v) for v in by_table.values())) for k in flops]
    differ = max(float(np.max(np.abs(a - b))) for a, b in shares)
    torch.cuda.synchronize()
    (summary, _, _), syncs = _record_syncs(lambda: train_cli.train(cfg, device=str(device)))
    in_step = [m for m, st in syncs if "_one_step" in st]
    remat = summary["remats"][0] if summary["remats"] else {}
    res["search_latency"] = {"cuts": cuts, "steps": summary["steps"], "finite_steps": summary["finite_steps"],
                             "syncs_in_a_step": len(in_step), "remat": remat, "cost_share_max_diff": differ,
                             "searched_macs": summary["searched"]["macs"]}
    log(f"search with prune.cost=latency_table (apps/atomnas_a_search.yml, cut: {' '.join(cuts[:-1])}): "
        f"{summary['steps']} steps, {summary['finite_steps']} finite, atoms {remat.get('atoms_before')} -> "
        f"{remat.get('atoms_after')}, searched {summary['searched']['macs'] / 1e6:.1f}M MACs, {len(in_step)} host "
        f"syncs inside a step; per-atom cost shares differ from the FLOPs ones by up to {differ:.2e}")
    if (summary["steps"] != BENCH_SEARCH_STEPS or summary["finite_steps"] != BENCH_SEARCH_STEPS or in_step
            or not remat or remat["atoms_after"] >= remat["atoms_before"] or differ <= 1e-6):
        raise AssertionError(f"search with the latency table: {res['search_latency']}")
    gc.collect()  # the benches' engines and graphs, before later phases
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 10: the serving tier (the zoo, the front door, the fleet, the cascade)
# ---------------------------------------------------------------------------


SERVE_ARMS = {"zoo": ("--zoo", "--zoo-requests", str(BENCH_ZOO_REQUESTS)),
              "fleet": ("--fleet", "--fleet-requests", str(BENCH_FLEET_REQUESTS), "--fleet-phase-s", BENCH_FLEET_PHASES)}


def start_serve_arm(arm: str):
    """Phase 9 (e)'s ``--zoo`` or ``--fleet`` arm of the serve bench, started
    as ``python -m ...bench.serve_bench`` runs it (its replicas are
    processes of their own either way): it runs beside a later phase whose
    checks are exact (bit for bit, counts), which a busy card cannot move,
    instead of alone (``finish_serve_arm``)."""
    return _bench_start("serve_bench", *SERVE_ARMS[arm])


def finish_serve_arm(arm: str, started, beside: str) -> dict:
    """The started arm's line, gated: (e)'s checks of docstring item 9."""
    out = _bench_finish("serve_bench", started)
    if arm == "zoo":
        zoo = out["zoo"]
        arms = zoo["arms"]
        if (not 0 < out["value"] < 1 or arms["cascade"]["escalations"] <= 0 or arms["cascade"]["answer_mismatches"]
                or arms["sharded"]["misroutes"] or not arms["big_only"]["bitwise_match_big"]
                or any(a["unresolved"] or a["failed"] for a in arms.values())):
            raise AssertionError(f"serve bench --zoo: {json.dumps(out)[:4000]}")
        log(f"serve bench --zoo (MobileNetV3-Small int8 + MobileNetV3-Large f32 at {IMAGE_SIZE}, 2 replicas, "
            f"{zoo['requests']} requests an arm at {zoo['target_qps']:.1f} QPS): cascade "
            f"{arms['cascade']['escalations']} escalations, dispatched FLOPs per request {out['value']:.4f}x big-only; "
            f"p99 big-only {arms['big_only']['p99_ms']:.2f} ms, sharded {arms['sharded']['p99_ms']:.2f} ms, cascade "
            f"{arms['cascade']['p99_ms']:.2f} ms ({out['_seconds']:.1f} s, beside {beside})")
        return out
    fleet = out["fleet"]
    rounds = [fleet["hedge_ab"]["unhedged"], fleet["hedge_ab"]["hedged"], fleet["kill"], *fleet["autoscale"]["phases"]]
    if (any(r["unresolved"] or r["failed"] for r in rounds) or fleet["kill"]["restarts"] < 1
            or not fleet["obs"]["p99_match"] or fleet["kill"]["replicas_after_restart"] != fleet["replicas"]):
        raise AssertionError(f"serve bench --fleet: {json.dumps(out)[:4000]}")
    ab = fleet["hedge_ab"]
    log(f"serve bench --fleet (MobileNetV3-Large at {IMAGE_SIZE}, {fleet['replicas']} replicas, one straggler of "
        f"{fleet['straggler']['latency_ms']:.0f} ms at rate 0.3, {fleet['target_qps']:.1f} QPS): p99 unhedged "
        f"{ab['unhedged']['p99_ms']:.2f} ms, hedged {ab['hedged']['p99_ms']:.2f} ms ({ab['hedged']['hedges']} "
        f"hedges); kill -9: {fleet['kill']['completed']} of {fleet['kill']['submitted']} completed, "
        f"{fleet['kill']['restarts']} restart(s); autoscaler n {fleet['autoscale']['n_start']} -> "
        f"{fleet['autoscale']['n_peak']} -> {fleet['autoscale']['n_end']} ({out['_seconds']:.1f} s, beside {beside})")
    return out


def _export_zoo(tmp: str, device) -> dict:
    """``small`` (MobileNetV3-Small 1.0 at 224, int8 weights calibrated on
    the card) and ``big`` (MobileNetV3-Large 1.0 at 224, float32), seeded
    weights and BN statistics, each stamped with its name and digest."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.serve import quant
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle

    dirs = {}
    for name, arch, seed in (("small", "mobilenet_v3_small", 10), ("big", "mobilenet_v3_large", 11)):
        net, _ = mbv3_depthwise_shapes(32, arch)
        gen = torch.Generator().manual_seed(seed)
        params, _ = net.init(gen)
        kw = {}
        if name == "small":
            # the gate is recorded, not enforced, on random weights (phase 5)
            raw = np.random.RandomState(seed).randint(0, 256, (16, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.uint8)
            kw = dict(quant_weights="int8", calib_images=quant.normalize_reference(raw), int8_top1_min=0.0,
                      device=device)
        dirs[name] = export_bundle(net, params, random_bn_state(net, gen), os.path.join(tmp, f"zoo_{name}"),
                                   model_name=name, **kw)
    return dirs


def _zoo_cfg(dirs: dict, *extra: str):
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    return parse_cli([f"app:{APP}", "serve.zoo.models=" + ",".join(f"{m}={d}" for m, d in dirs.items()),
                      f"data.image_size={IMAGE_SIZE}", "serve.compute_dtype=float32", *extra])


def _dequantized(bundle_dir: str, net):
    """An int8 bundle's f32 twin: every ``w_q`` x ``w_scale`` pair of its
    ``weights.npz`` as one f32 weight (phase 5's reference)."""
    import numpy as np

    from yet_another_mobilenet_series_tpu_torch.models import convert
    from yet_another_mobilenet_series_tpu_torch.serve import quant
    from yet_another_mobilenet_series_tpu_torch.serve.export import InferenceBundle

    with np.load(os.path.join(bundle_dir, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    deq = {}
    for key, v in flat.items():
        if key.endswith("/w_q"):  # a/w_q + a/w_scale -> a/w
            deq[key[:-2]] = quant.dequantize_array(v, flat[key[:-1] + "scale"])
        elif not key.endswith("/w_scale"):
            deq[key] = v
    return InferenceBundle(net=net, params=convert.from_jax(deq), meta={})


def phase_zoo_engine(device, tmp: str, dirs: dict, before_timing=None) -> dict:
    """(a) One engine serves both tenants on the card, built as the CLI
    builds it (``ModelZoo``, ``engine_kwargs`` of the shipped config, the
    pipelined batcher), the counts at 0 just before and read just after:
    single images of both tenants through the batcher, and bulk requests
    of 40 and 64 rows (the fused ladder) to ``engine.predict``. Gates:
    every dispatch a replay, each tenant's graphs hold its own K1 launches
    per forward (11 and 15), the wrapper launched nothing outside warm runs
    and captures; logits against each tenant's single-bundle CPU forward
    (SLICE_ATOL/SLICE_RTOL), the int8 tenant against its dequantized f32
    forward on the card (top-1 agreement, phase 5's gate), and the graph
    paths bitwise equal to single-bundle engines on the card. The card's own
    count of K1's launches equals the accounting over the traffic, and 11
    and 15 a forward over SERVED_FORWARDS forwards of each tenant.
    ``before_timing`` (when given) is called before the direct QPS is timed:
    (b)'s server, started beside (a), is up and idle by then."""
    tf32_off("the zoo's logits against the CPU forward at the float32 bar")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.config import QuantConfig
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.zoo import ModelZoo

    cfg = _zoo_cfg(dirs)
    zoo = ModelZoo.from_config(cfg.serve.zoo)
    reg = get_registry()
    rng = np.random.RandomState(21)
    singles = {m: rng.normal(0, 1, (ZOO_SINGLES, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32) for m in ZOO_PER_FORWARD}
    bulk = {m: [rng.normal(0, 1, (n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32) for n in ZOO_BULK_ROWS]
            for m in ZOO_PER_FORWARD}

    # the main path, counts at 0 just before, read just after
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    card0 = _k1_on_card()
    s0 = reg.snapshot()
    t0 = time.perf_counter()
    engine = InferenceEngine(**zoo.engine_kwargs(), device=str(device), **serve_cli.engine_kwargs(cfg))
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    batcher = serve_cli._make_batcher(cfg, engine).start()
    try:
        futs = {m: [batcher.submit(img, model=m) for img in singles[m]] for m in ZOO_PER_FORWARD}
        served = {m: np.stack([f.result(timeout=120) for f in fs]) for m, fs in futs.items()}
    finally:
        batcher.stop()
    bulk_out = {m: [engine.predict(x, model=m) for x in xs] for m, xs in bulk.items()}
    torch.cuda.synchronize()
    launches = fused_depthwise.launches
    s1 = reg.snapshot()
    report = engine.graph_report()
    k1 = _k1_accounting(report, launches, ZOO_PER_FORWARD)
    k1["card"] = _k1_card_gate(card0, k1["launches"], "the zoo engine's traffic")
    k1["by_model"] = {m: sum(g["replays"] * g["k1_launches"] + g["warm_k1"] for g in report if g["model"] == m)
                      for m in ZOO_PER_FORWARD}
    dispatches = int(s1.get("serve.dispatch_seconds.count", 0) - s0.get("serve.dispatch_seconds.count", 0))
    replays = int(s1.get("serve.graph_replays", 0) - s0.get("serve.graph_replays", 0))
    res = {"warmup_s": warmup_s, "graphs": len(report), "dispatches": dispatches, "replays": replays, "k1": k1,
           "wrapper_launches": launches, "models": {m: engine.model_weights(m) for m in engine.models}}
    log(f"zoo engine (small = MobileNetV3-Small 1.0 int8, big = MobileNetV3-Large 1.0 f32, at {IMAGE_SIZE}; the "
        f"shipped ladder): {len(report)} graphs captured in {warmup_s:.1f} s; {ZOO_SINGLES} single images and bulk "
        f"requests of {'/'.join(map(str, ZOO_BULK_ROWS))} rows per tenant: {dispatches} dispatches = {replays} "
        f"replays; K1 {k1['launches']} launches (small {k1['by_model']['small']}, big {k1['by_model']['big']}; "
        f"{ZOO_PER_FORWARD['small']} and {ZOO_PER_FORWARD['big']} per forward in every graph), {k1['card']} on the "
        f"card's own counter")
    if dispatches != replays or not replays or set(engine.models) != {"small", "big"}:
        raise AssertionError(f"zoo engine: {res}")

    # logits: the card against each tenant's single-bundle CPU forward
    errs = {}
    for m in ZOO_PER_FORWARD:
        cpu = InferenceEngine(zoo.bundle(m), device="cpu", buckets=(8,))
        errs[m] = max(_cpu_check(f"zoo {m} singles", served[m], cpu.predict(singles[m])),
                      _cpu_check(f"zoo {m} bulk", bulk_out[m][0][:CPU_ROWS], cpu.predict(bulk[m][0][:CPU_ROWS])))
    # the int8 tenant against its dequantized f32 forward, on the card
    gate = QuantConfig().int8_top1_min
    a = rng.normal(0, 1, (64, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    got = engine.predict(a, model="small")
    want = InferenceEngine(_dequantized(dirs["small"], zoo.bundle("small").net), device=str(device),
                           buckets=(32,)).predict(a)
    agree = float(np.mean(np.argmax(got, -1) == np.argmax(want, -1)))
    # the graph paths bitwise against single-bundle engines on the card, and
    # each tenant's direct QPS at buckets 1 and 32 against its single-bundle
    # engine's, in turns (zoo, single, single, zoo)
    bitwise, qps = {}, {}
    if before_timing is not None:
        before_timing()
    for m in ZOO_PER_FORWARD:
        single = InferenceEngine(zoo.bundle(m), device=str(device), **serve_cli.engine_kwargs(cfg))
        single.warmup()
        bitwise[m] = (all(np.array_equal(single.predict(x), y) for x, y in zip(bulk[m], bulk_out[m]))
                      and np.array_equal(single.predict(singles[m][:1]), engine.predict(singles[m][:1], model=m)))
        for b in (1, 32):
            x = bulk[m][1][:b]
            times = {"zoo": [], "single": []}
            for who in ("zoo", "single", "single", "zoo"):
                fn = (lambda: engine.predict(x, model=m)) if who == "zoo" else (lambda: single.predict(x))
                fn()
                t1 = time.perf_counter()
                for _ in range(ZOO_TIMED_ITERS):
                    fn()
                times[who].append(ZOO_TIMED_ITERS * b / (time.perf_counter() - t1))
            qps[f"{m}_b{b}"] = {who: sum(v) / len(v) for who, v in times.items()}
        del single
    res.update(cpu_max_abs_err=errs, int8_agreement=agree, int8_max_abs_err=float(np.abs(got - want).max()),
               bitwise_vs_single=bitwise, direct_qps=qps)
    log("zoo direct QPS (engine.predict, exact buckets, mean of 2 turns) tenant of the zoo / single-bundle engine: "
        + ", ".join(f"{k} {v['zoo']:.1f} / {v['single']:.1f}" for k, v in qps.items()))
    log(f"zoo logits: card vs single-bundle CPU forward max |err| small {errs['small']:.3e}, big {errs['big']:.3e} "
        f"(atol {SLICE_ATOL}, rtol {SLICE_RTOL}); int8 small vs its dequantized f32 forward on the card: top-1 "
        f"agreement {agree:.3f} (gate {gate}), max |err| {res['int8_max_abs_err']:.3e}; graph paths bitwise equal "
        f"to single-bundle engines: {bitwise}")
    if agree < gate or not all(bitwise.values()):
        raise AssertionError(f"zoo engine logits: {res}")

    # K1 counted on the card, SERVED_FORWARDS forwards of each tenant at bucket 8
    x8 = np.random.RandomState(13).normal(0, 1, (8, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    counted = {}
    for m in ZOO_PER_FORWARD:
        card1 = _k1_on_card()
        for _ in range(SERVED_FORWARDS):
            engine.predict(x8, model=m)
        counted[m] = _k1_card_gate(card1, ZOO_PER_FORWARD[m] * SERVED_FORWARDS,
                                   f"{SERVED_FORWARDS} forwards of the zoo's {m} tenant at bucket 8")
    res["card_per_forward"] = {m: counted[m] / SERVED_FORWARDS for m in ZOO_PER_FORWARD}
    log(f"K1 on the card's own counter: {counted['small']} launches in {SERVED_FORWARDS} small forwards, "
        f"{counted['big']} in {SERVED_FORWARDS} big ones at bucket 8")
    res["faults"] = _zoo_under_faults(cfg, engine, singles)
    res["engine"] = engine  # (b) and (c) hold the replicas against it; popped by the caller
    return res


def _zoo_under_faults(cfg, engine, singles: dict) -> dict:
    """F3 (ROADMAP queue 3), repaired: the zoo engine behind the port's
    fault injector (``serve/faults.py``, its first ZOO_FAULTS dispatches
    failing at the result), the CLI's batcher and an admission controller
    that retries: each request answers from the tenant it named, bit for
    bit the zoo engine's own answer, and the injected failures are
    counted."""
    import numpy as np

    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry
    from yet_another_mobilenet_series_tpu_torch.serve.admission import AdmissionController
    from yet_another_mobilenet_series_tpu_torch.serve.faults import FaultyEngine

    reg = get_registry()
    s0 = reg.snapshot()
    batcher = serve_cli._make_batcher(cfg, FaultyEngine(engine, seed=0, fail_first_n=ZOO_FAULTS,
                                                        fail_at="result")).start()
    admission = AdmissionController(batcher, max_retries=ZOO_FAULTS, retry_backoff_ms=1.0)
    answers = {}
    try:
        for m in ZOO_PER_FORWARD:
            answers[m] = [admission.submit(img, model=m).result(timeout=120) for img in singles[m][:ZOO_FAULT_REQUESTS]]
    finally:
        batcher.stop()
    s1 = reg.snapshot()
    bitwise = {m: all(np.array_equal(got, engine.predict(singles[m][i: i + 1], model=m)[0])
                      for i, got in enumerate(answers[m])) for m in ZOO_PER_FORWARD}
    failures = int(s1.get("serve.faults.failures", 0) - s0.get("serve.faults.failures", 0))
    shapes = {m: answers[m][0].shape for m in ZOO_PER_FORWARD}
    log(f"zoo under faults (F3): the first {ZOO_FAULTS} dispatches failed by the injector ({failures} counted) and "
        f"were retried; {ZOO_FAULT_REQUESTS} requests a tenant answered by the tenant they named, bit for bit: "
        f"{bitwise} (logit shapes {shapes})")
    if failures != ZOO_FAULTS or not all(bitwise.values()):
        raise AssertionError(f"the zoo under faults: failures {failures}, bitwise {bitwise}")
    return {"failures": failures, "bitwise": bitwise}


def _wait_file(path: str, proc, timeout: float, what: str) -> dict:
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise AssertionError(f"{what} exited {proc.returncode} before it bound")
        if time.time() > deadline:
            raise AssertionError(f"{what} did not bind within {timeout:.0f} s")
        time.sleep(0.2)
    with open(path) as f:
        return json.load(f)


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def _obs_tool(module: str, *argv: str) -> str:
    """The standard output of ``python -m ...obs.<module> argv`` (the
    post-run report or the fleet trace merge); a non-zero exit fails."""
    proc = subprocess.run([sys.executable, "-m", f"yet_another_mobilenet_series_tpu_torch.obs.{module}", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=OBS_TOOL_TIMEOUT_S)
    if proc.returncode:
        raise AssertionError(f"obs.{module} {' '.join(argv)} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def _check_sections(what: str, text: str, sections) -> None:
    missing = [s for s in sections if s not in text]
    if missing:
        raise AssertionError(f"{what}: no {missing} in\n{text[-3000:]}")


def start_front_door(device, tmp: str, dirs: dict) -> dict:
    """(b)'s server, ``python -m ...cli.serve --listen`` serving the zoo,
    started: its start (a new process: imports, a context on the card, the
    graphs' captures) runs beside (a); ``front_door_up`` waits for it to
    bind."""
    log_dir = os.path.join(tmp, "front_door")
    out_path = os.path.join(tmp, "front_door.log")
    cfg_args = [f"app:{APP}", "--listen", "serve.zoo.models=" + ",".join(f"{m}={d}" for m, d in dirs.items()),
                f"data.image_size={IMAGE_SIZE}", "serve.drain_timeout_s=20", f"train.log_dir={log_dir}",
                "--device", device.type]
    t0 = time.perf_counter()
    with open(out_path, "w") as out_f:
        proc = subprocess.Popen([sys.executable, "-m", "yet_another_mobilenet_series_tpu_torch.cli.serve", *cfg_args],
                                cwd=REPO, stdout=out_f, stderr=subprocess.STDOUT)
    return {"proc": proc, "t0": t0, "log_dir": log_dir, "out_path": out_path, "addr": None}


def front_door_up(started: dict) -> dict:
    """The started server's address once it has bound (its startup seconds
    recorded), waiting for it the first time."""
    if started["addr"] is None:
        started["addr"] = _wait_file(os.path.join(started["log_dir"], "listen_addr.json"), started["proc"], 400,
                                     "cli.serve --listen")
        started["startup_s"] = time.perf_counter() - started["t0"]
    return started["addr"]


def phase_front_door(device, tmp: str, dirs: dict, engine, started: dict) -> dict:
    """(b) ``python -m ...cli.serve --listen`` serving the zoo on the card
    (the shipped config; ``start_front_door``), over loopback HTTP: answers
    with and without ``X-Model`` bitwise equal to the in-process engine's at
    bucket 1, an unknown model a typed 400, ``/healthz``, ``/metrics`` and
    ``/varz`` (the compile report's ``_m<name>`` keys), a ``/profile``
    window that holds K1 records, and SIGTERM under load: every request
    resolved (an answer or a typed error), a clean drain, exit 0."""
    import numpy as np

    from yet_another_mobilenet_series_tpu_torch.bench import trace_ops
    from yet_another_mobilenet_series_tpu_torch.serve.client import (
        ClientError, ClientHTTPError, ClientTimeout, ReplicaClient)

    proc, out_path = started["proc"], started["out_path"]
    try:
        addr = front_door_up(started)
        res = {"startup_s": started["startup_s"]}
        client = ReplicaClient(addr["host"], addr["port"], timeout_s=120.0)
        rng = np.random.RandomState(31)
        x = rng.normal(0, 1, (FRONT_DOOR_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
        lat, mismatches = [], 0
        for i in range(FRONT_DOOR_IMAGES):
            for model in ("small", "big", None):
                t1 = time.perf_counter()
                got = client.predict(x[i], model=model)
                lat.append(time.perf_counter() - t1)
                want = engine.predict(x[i: i + 1], model=model)[0]
                mismatches += not np.array_equal(got, want)
        lat.sort()
        res.update(requests=len(lat), mismatches=mismatches, http_p50_ms=lat[len(lat) // 2] * 1e3)
        try:
            client.predict(x[0], model="huge")
            unknown = None
        except ClientHTTPError as e:
            unknown = (e.status, e.tag)
        status, health = client.healthz()
        metrics = client.metrics_text()
        build = next((ln for ln in metrics.splitlines() if ln.startswith("build_info{")), "")
        _, varz = client.varz()
        keys = sorted(k for k in varz.get("executables", {}) if k.endswith(("_msmall", "_mbig")))
        res.update(unknown_model=unknown, healthz=status, build_info=build, varz_keys=keys)
        # a profiler window over live traffic
        st_start = client._request_json("POST", "/profile/start")[0]
        for i in range(PROFILED_REQUESTS):
            client.predict(x[i % FRONT_DOOR_IMAGES], model="small")
            client.predict(x[i % FRONT_DOOR_IMAGES], model="big")
        st_stop, _, doc = client._request_json("POST", "/profile/stop")
        k1 = 0
        if st_stop == 200:
            trace, _ = trace_ops.load_trace(doc["trace"])
            agg = trace_ops.aggregate(trace)
            k1 = sum(c for name, c in agg["counts"].items() if "fused_dw_kernel" in name) if agg["device"] else 0
        want_k1 = PROFILED_REQUESTS * (ZOO_PER_FORWARD["small"] + ZOO_PER_FORWARD["big"])
        res.update(profile_status=(st_start, st_stop), profiled_k1=k1, profiled_k1_expected=want_k1)
        client.close()
        log(f"front door (cli.serve --listen, the zoo on the card, shipped config): up in {res['startup_s']:.1f} s "
            f"(started beside (a)); "
            f"{len(lat)} sequential requests with and without X-Model, {mismatches} differ from the in-process "
            f"engine (bucket 1); HTTP p50 {res['http_p50_ms']:.2f} ms a request; unknown model -> {unknown}; "
            f"/healthz {status}; /varz compile report keys {keys}; /profile window: {k1} K1 records for "
            f"{want_k1} launches")
        if (mismatches or unknown is None or unknown[0] != 400 or status != 200 or "gpu_name=" not in build
                or not any(k.endswith("_msmall") for k in keys) or not any(k.endswith("_mbig") for k in keys)
                or (st_start, st_stop) != (200, 200) or k1 <= 0):
            raise AssertionError(f"front door: {res}")

        # SIGTERM under load: every request is answered, or refused with a
        # typed verdict ("draining", or the connection refused once closed).
        # Concurrent requests share batches, so an answer is held to its
        # bucket-1 reference at the float32 bar, not bit for bit
        outcomes = {"completed": 0, "typed": 0, "failed": 0, "unresolved": 0, "wrong": 0}
        verdicts: dict = {}
        lock = threading.Lock()

        def load(seed):
            c = ReplicaClient(addr["host"], addr["port"], timeout_s=60.0)
            try:
                for j in range(DRAIN_REQUESTS):
                    i = (seed + j) % FRONT_DOOR_IMAGES
                    model = ("small", "big")[j % 2]
                    try:
                        got = c.predict(x[i], model=model)
                        ref = engine.predict(x[i: i + 1], model=model)[0]
                        key = "completed" if np.all(np.abs(got - ref) <= SLICE_ATOL + SLICE_RTOL * np.abs(ref)) \
                            else "wrong"
                    except ClientHTTPError as e:
                        key = "typed" if e.status in (503, 429) else "failed"
                        verdict = f"{e.status} {e.tag}" + (f" {e}" if e.status == 500 else "")
                    except ClientTimeout:
                        key, verdict = "unresolved", "timeout"
                    except ClientError as e:  # refused or reset once the server closed: a typed client error
                        key, verdict = "typed", type(e).__name__
                    else:
                        verdict = "200"
                    with lock:
                        outcomes[key] += 1
                        verdicts[verdict] = verdicts.get(verdict, 0) + 1
            finally:
                c.close()

        threads = [threading.Thread(target=load, args=(s,)) for s in range(DRAIN_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=180)
        rc = proc.wait(timeout=120)
        drain_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = _tail(out_path, 20000)
    res.update(drain=outcomes, drain_verdicts=verdicts, drain_rc=rc, drain_s=drain_s,
               clean="clean" in text.split("drained in")[-1])
    log(f"front door SIGTERM under {DRAIN_CLIENTS} clients: {outcomes} ({verdicts}), exit {rc}, drained in {drain_s:.2f} s "
        f"({'clean' if res['clean'] else 'NOT clean'})")
    if (any(t.is_alive() for t in threads) or rc != 0 or not res["clean"] or outcomes["unresolved"]
            or outcomes["failed"] or outcomes["wrong"] or sum(outcomes.values()) != DRAIN_CLIENTS * DRAIN_REQUESTS):
        raise AssertionError(f"front door drain: {res} {text[-3000:]}")
    return res


def _compute_apps() -> list[int]:
    """The pids of the processes that hold a context on the card
    (``nvidia-smi --query-compute-apps``)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return sorted(int(ln.strip()) for ln in out.stdout.splitlines() if ln.strip().isdigit())


def phase_fleet(device, tmp: str, dirs: dict, engine) -> dict:
    """(c) ``python -m ...cli.fleet`` on the card: two replicas placed
    ``small;big`` behind the router, the cascade at the median margin of a
    seeded image set (from the in-process engine at bucket 1), the replicas
    at bucket 1 (``serve.buckets=[1]``, as the serve bench's zoo arm) so
    that answers under concurrent load compare bit for bit. Gates:
    pinned answers bitwise equal to the in-process engine; the cascade
    escalates (> 0) and each answer is bitwise one of the two per-image
    references; its dispatched FLOPs per request (the replicas' ``/varz``)
    strictly below a big-only round's; kill -9 of the big replica under
    cascade load leaves every request completed or typed-rejected (failed
    0, unresolved 0) and the supervisor restarts it; the supervisor holds
    no context on the card (``nvidia-smi``'s compute apps); SIGTERM drains
    the fleet with exit 0."""
    import numpy as np

    from yet_another_mobilenet_series_tpu_torch.serve.cascade import softmax_margin
    from yet_another_mobilenet_series_tpu_torch.serve.client import (
        ClientError, ClientHTTPError, ClientTimeout, ReplicaClient)

    rng = np.random.RandomState(41)
    images = rng.normal(0, 1, (FLEET_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    refs = {m: [engine.predict(images[i: i + 1], model=m)[0] for i in range(FLEET_IMAGES)] for m in ("small", "big")}
    margins = [softmax_margin(r) for r in refs["small"]]
    threshold = float(np.median(margins))
    log_dir = os.path.join(tmp, "fleet")
    out_path = os.path.join(tmp, "fleet.log")
    fleet_app = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "serve_fleet.yml")
    args = [f"app:{fleet_app}", "serve.zoo.models=" + ",".join(f"{m}={d}" for m, d in dirs.items()),
            "serve.zoo.placement=small;big", "serve.zoo.cascade.enable=true", "serve.zoo.cascade.small=small",
            "serve.zoo.cascade.big=big", f"serve.zoo.cascade.threshold={threshold}",
            # the gray-failure sweep on, as shipped: each replica is the only one
            # serving its model, so F7's peer groups never eject it
            # bucket 1 under concurrent load too: every answer compares bit for bit
            "serve.buckets=[1]", "serve.max_batch=1",
            f"data.image_size={IMAGE_SIZE}", "serve.drain_timeout_s=20",
            # traced: the router's and each replica's spans, merged after the run
            "obs.trace=true",
            "serve.fleet.spawn_timeout_s=400", f"train.log_dir={log_dir}", "--device", device.type]
    t0 = time.perf_counter()
    with open(out_path, "w") as out_f:
        proc = subprocess.Popen([sys.executable, "-m", "yet_another_mobilenet_series_tpu_torch.cli.fleet", *args],
                                cwd=REPO, stdout=out_f, stderr=subprocess.STDOUT)
    res: dict = {"threshold": threshold, "margin_range": [float(min(margins)), float(max(margins))]}
    try:
        addr = _wait_file(os.path.join(log_dir, "listen_addr.json"), proc, 600, "cli.fleet")
        res["startup_s"] = time.perf_counter() - t0
        reps = [_wait_file(os.path.join(log_dir, f"r{i}", "listen_addr.json"), proc, 60, f"replica r{i}")
                for i in range(2)]
        apps = _compute_apps()
        rep_pids = [r["pid"] for r in reps]
        res["compute_apps"] = {"pids": apps, "supervisor": proc.pid, "replicas": rep_pids, "smoke": os.getpid()}
        if all(p in apps for p in rep_pids):
            supervisor_ctx = proc.pid in apps
        else:  # pids from another namespace: count the contexts instead (this process and the two replicas)
            supervisor_ctx = len(apps) != 3
        res["supervisor_holds_context"] = supervisor_ctx
        router = ReplicaClient(addr["host"], addr["port"], timeout_s=120.0)
        replica_clients = [ReplicaClient(r["host"], r["port"], timeout_s=30.0) for r in reps]

        def fleet_flops() -> float:
            return sum(float(c.varz()[1]["metrics"].get("serve.dispatched_flops", 0)) for c in replica_clients)

        pinned = sum(not np.array_equal(router.predict(images[i], model=m), refs[m][i])
                     for i in range(4) for m in ("small", "big"))
        # big only against the cascade, sequentially, FLOPs from the replicas
        f0 = fleet_flops()
        t1 = time.perf_counter()
        for i in range(FLEET_IMAGES):
            router.predict(images[i], model="big")
        big_s = time.perf_counter() - t1
        f1 = fleet_flops()
        esc0 = router.varz()[1]["metrics"].get("serve.cascade.escalations", 0)
        t1 = time.perf_counter()
        answers = [router.predict(images[i]) for i in range(FLEET_IMAGES)]
        cascade_s = time.perf_counter() - t1
        f2 = fleet_flops()
        esc = int(router.varz()[1]["metrics"].get("serve.cascade.escalations", 0) - esc0)
        as_big = sum(np.array_equal(a, refs["big"][i]) and not np.array_equal(a, refs["small"][i])
                     for i, a in enumerate(answers))
        as_small = sum(np.array_equal(a, refs["small"][i]) for i, a in enumerate(answers))
        big_fpr, cascade_fpr = (f1 - f0) / FLEET_IMAGES, (f2 - f1) / FLEET_IMAGES
        res.update(pinned_mismatches=int(pinned), escalations=esc, answers_big=int(as_big),
                   answers_small=int(as_small), big_only_flops_per_request=big_fpr,
                   cascade_flops_per_request=cascade_fpr, cascade_vs_big_only=cascade_fpr / big_fpr if big_fpr else None,
                   big_only_ms_per_request=big_s / FLEET_IMAGES * 1e3,
                   cascade_ms_per_request=cascade_s / FLEET_IMAGES * 1e3)
        log(f"fleet (cli.fleet, 2 replicas on the card, placement small;big) up in {res['startup_s']:.1f} s; compute "
            f"apps {apps} (supervisor {proc.pid}, replicas {rep_pids}, this process {os.getpid()}): supervisor holds "
            f"a context: {supervisor_ctx}; {pinned} pinned mismatches; cascade at margin {threshold:.3e}: "
            f"{esc} of {FLEET_IMAGES} escalated, answers {as_small} small + {as_big} big (bitwise); dispatched FLOPs "
            f"per request {cascade_fpr / 1e9:.4f} G against big-only {big_fpr / 1e9:.4f} G "
            f"({res['cascade_vs_big_only']:.4f}x); sequential {res['cascade_ms_per_request']:.2f} ms a cascade request, "
            f"{res['big_only_ms_per_request']:.2f} ms a big-only one")
        if (supervisor_ctx or pinned or esc <= 0 or as_big + as_small != FLEET_IMAGES or as_big != esc
                or not cascade_fpr < big_fpr):
            raise AssertionError(f"fleet: {res}")

        # kill -9 the big replica under cascade load
        outcomes = {"completed": 0, "typed": 0, "failed": 0, "unresolved": 0}
        lat: list = []
        lock = threading.Lock()

        def load(seed):
            c = ReplicaClient(addr["host"], addr["port"], timeout_s=60.0)
            try:
                for j in range(KILL_REQUESTS):
                    i = (seed * KILL_REQUESTS + j) % FLEET_IMAGES
                    t2 = time.perf_counter()
                    try:
                        a = c.predict(images[i])
                        ok = np.array_equal(a, refs["small"][i]) or np.array_equal(a, refs["big"][i])
                        key = "completed" if ok else "failed"
                    except ClientHTTPError as e:
                        key = "typed" if e.status in (429, 503) else "failed"
                    except ClientTimeout:
                        key = "unresolved"
                    except ClientError:  # the router itself refused or reset: it never does while up
                        key = "failed"
                    with lock:
                        outcomes[key] += 1
                        lat.append(time.perf_counter() - t2)
            finally:
                c.close()

        threads = [threading.Thread(target=load, args=(s,)) for s in range(KILL_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        os.kill(reps[1]["pid"], signal.SIGKILL)
        for t in threads:
            t.join(timeout=300)
        lat.sort()
        path = os.path.join(log_dir, "r1", "listen_addr.json")
        deadline = time.time() + 400
        while time.time() < deadline:
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        if json.load(f)["pid"] != reps[1]["pid"]:
                            break
                except (OSError, ValueError):
                    pass
            time.sleep(0.5)
        restarts = int(router.varz()[1]["metrics"].get("fleet.restarts", 0))
        deadline = time.time() + 120
        back = False
        while time.time() < deadline and not back:
            try:
                back = np.array_equal(router.predict(images[0], model="big"), refs["big"][0])
            except ClientHTTPError:
                time.sleep(0.5)
        res["kill"] = {**outcomes, "restarts": restarts, "big_back_bitwise": back,
                       "p50_ms": lat[len(lat) // 2] * 1e3 if lat else None,
                       "p99_ms": lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))] * 1e3 if lat else None}
        log(f"fleet kill -9 of the big replica under {KILL_CLIENTS} cascade clients: {outcomes}, p50 "
            f"{res['kill']['p50_ms']:.2f} ms, p99 {res['kill']['p99_ms']:.2f} ms; restarts {restarts}, the new big "
            f"replica answers bitwise: {back}")
        if (outcomes["failed"] or outcomes["unresolved"] or any(t.is_alive() for t in threads)
                or sum(outcomes.values()) != KILL_CLIENTS * KILL_REQUESTS or restarts < 1 or not back):
            raise AssertionError(f"fleet kill: {res['kill']} {_tail(out_path)}")
        router.close()
        for c in replica_clients:
            c.close()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    res["exit"] = rc
    if rc != 0:
        raise AssertionError(f"the fleet exited {rc}: {_tail(out_path)}")
    # the post-run tools on the fleet's log dir: the router's and the
    # replicas' traces merged on one timeline, and the report's fleet view
    merge_out = _obs_tool("trace_merge", log_dir)
    with open(os.path.join(log_dir, "merged_trace.json")) as f:
        merged = json.load(f)
    lanes = [p["process_name"] for p in merged["processes"]]
    fleet_report = _obs_tool("report", "--fleet", log_dir)
    res["trace_merge"] = {"events": len(merged["traceEvents"]), "lanes": lanes,
                          "offsets_ms": [p["offset_us"] / 1e3 for p in merged["processes"]],
                          "printed": merge_out.strip().splitlines()[-1]}
    log(f"fleet trace merge: {res['trace_merge']['printed']}; lanes {lanes} at offsets "
        + ", ".join(f"{o:+.3f}" for o in res["trace_merge"]["offsets_ms"]) + " ms; obs.report --fleet: "
        + next(line.strip() for line in fleet_report.splitlines() if "replica slots" in line))
    _check_sections("obs.report --fleet", fleet_report, ("## fleet", "replica slots: 2 (2 with traces)",
                                                          "merged trace: ", f"{len(lanes)} process lanes"))
    if len(lanes) != 3 or not merged["traceEvents"] or any(
            not any(e.get("pid") == p["pid"] and e.get("ph") != "M" for e in merged["traceEvents"])
            for p in merged["processes"]):
        raise AssertionError(f"the merged fleet trace: lanes {lanes}, {len(merged['traceEvents'])} events, a lane "
                             "without events, or not the router and two replicas")
    return res


def phase_serving_tier(device, tmp: str) -> dict:
    """Phase 10 (docstring, item 10): the zoo engine, the front door and the
    fleet with the cascade, on the card."""
    import torch

    lap = _laps("10")
    dirs = _export_zoo(tmp, device)
    started = start_front_door(device, tmp, dirs)
    lap("the zoo's bundles")
    try:
        zoo = phase_zoo_engine(device, tmp, dirs, before_timing=lambda: front_door_up(started))
    except BaseException:
        started["proc"].kill()  # the server ends before the raise goes on
        started["proc"].wait()
        raise
    lap("(a) the zoo engine")
    engine = zoo.pop("engine")
    front = phase_front_door(device, tmp, dirs, engine, started)
    lap("(b) the front door")
    fleet = phase_fleet(device, tmp, dirs, engine)
    lap("(c) the fleet")
    del engine
    torch.cuda.empty_cache()
    return {"zoo": zoo, "front_door": front, "fleet": fleet}


def torchvision_mbv2_state_dict(net, seed: int) -> dict:
    """A torchvision-layout MobileNetV2 ``state_dict`` for ``net`` from
    seeded tensors (torchvision's key names and shapes, its init scales:
    kaiming fan-out convs; BN affines and running statistics drawn away from
    the identity so that the import's BN mapping matters)."""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    sd: dict = {}

    def conv(key, o, i, k, groups=1):
        std = math.sqrt(2.0 / (o * k * k // groups))
        sd[f"{key}.weight"] = torch.randn((o, i // groups, k, k), generator=gen) * std

    def bn(key, c):
        sd[f"{key}.weight"] = torch.rand(c, generator=gen) * 0.5 + 0.75
        sd[f"{key}.bias"] = torch.randn(c, generator=gen) * 0.1
        sd[f"{key}.running_mean"] = torch.randn(c, generator=gen) * 0.1
        sd[f"{key}.running_var"] = torch.rand(c, generator=gen) * 0.5 + 0.75
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    conv("features.0.0", net.stem.out_channels, 3, net.stem.kernel_size)
    bn("features.0.1", net.stem.out_channels)
    for i, blk in enumerate(net.blocks):
        f, e, j = f"features.{i + 1}.conv", blk.expanded_channels, 0
        if blk.has_expand:
            conv(f"{f}.0.0", e, blk.in_channels, 1)
            bn(f"{f}.0.1", e)
            j = 1
        conv(f"{f}.{j}.0", e, e, blk.kernel_sizes[0], groups=e)
        bn(f"{f}.{j}.1", e)
        conv(f"{f}.{j + 1}", blk.out_channels, e, 1)
        bn(f"{f}.{j + 2}", blk.out_channels)
    hi = len(net.blocks) + 1
    conv(f"features.{hi}.0", net.head.out_channels, net.head.in_channels, 1)
    bn(f"features.{hi}.1", net.head.out_channels)
    sd["classifier.1.weight"] = torch.randn((net.classifier.out_features, net.classifier.in_features),
                                            generator=gen) * LIFE_CLASSIFIER_STD
    sd["classifier.1.bias"] = torch.zeros(net.classifier.out_features)
    return sd


def _life_eval_cfg(tmp: str, tag: str, pth: str):
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    return parse_cli([f"app:{LIFE_EVAL_APP}", f"train.torch_pretrained={pth}", "data.dataset=fake",
                      f"data.fake_eval_size={LIFE_EVAL_IMAGES}", f"train.log_dir={os.path.join(tmp, 'life_' + tag)}"])


def phase_life_eval(device, tmp: str) -> tuple[dict, str, object]:
    """(a) A torchvision-layout MobileNetV2 1.0 state_dict from seeded
    tensors, saved as .pth, evaluated by cli/train.py with
    apps/eval_mobilenet_v2.yml (train.test_only, float32) and
    train.torch_pretrained on the card and with --device cpu: loss and top-1
    agree, and the card's logits of the run's weights equal the imported
    tree's Network.apply on the CPU (rtol 1e-4, atol 1e-5, TF32 off)."""
    tf32_off("the eval-only run, card against CPU, and its logits at the float32 forward bar")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.ckpt.torch_import import load_torch_checkpoint
    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.data.pipeline import FakeImages
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise

    cfg = _life_eval_cfg(tmp, "probe", "x.pth")
    net = get_model(cfg.model, IMAGE_SIZE)
    pth = os.path.join(tmp, "mobilenet_v2_torchvision_layout.pth")
    torch.save(torchvision_mbv2_state_dict(net, 11), pth)
    runs = {}
    for tag, dev in (("card", str(device)), ("cpu", "cpu")):
        torch.cuda.synchronize()
        fused_depthwise.launches = 0
        t0 = time.perf_counter()
        summary, ts, rnet = train_cli.train(_life_eval_cfg(tmp, tag, pth), device=dev)
        runs[tag] = (summary, ts, time.perf_counter() - t0, fused_depthwise.launches)
    (card, ts, card_s, card_k1), (cpu, _, cpu_s, _) = runs["card"], runs["cpu"]
    if not (card["test_only"] and card["device"].startswith("cuda") and card["eval_n"] == LIFE_EVAL_IMAGES):
        raise AssertionError(f"eval-only run on the card: {card}")
    loss_rel = abs(card["eval_loss"] - cpu["eval_loss"]) / abs(cpu["eval_loss"])
    data_cfg = dataclasses.replace(cfg.data, fake_num_classes=cfg.model.num_classes)
    batch = next(FakeImages(data_cfg, device).eval_batches(cfg.train.eval_batch_size))
    cpu_batch = next(FakeImages(data_cfg, "cpu").eval_batches(cfg.train.eval_batch_size))
    same_images = torch.equal(batch["image"].cpu(), cpu_batch["image"]) and torch.equal(batch["label"].cpu(),
                                                                                         cpu_batch["label"])
    params, state = load_torch_checkpoint(pth, net)
    with torch.inference_mode():
        got = rnet.apply(ts.ema_params, ts.ema_state, batch["image"], train=False).cpu().numpy()
        want = net.apply(params, state, batch["image"].cpu(), train=False).numpy()
    err = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=-1)[:, -2:]
    res = {"card": card, "cpu": cpu, "loss_rel": loss_rel, "logits_max_abs_err": err,
           "max_logit": float(np.abs(want).max()), "min_top2_margin": float((top2[:, 1] - top2[:, 0]).min()),
           "card_s": card_s, "cpu_s": cpu_s, "pth_bytes": os.path.getsize(pth), "k1_launches": card_k1,
           "same_eval_images": same_images}
    log(f"life (a): apps/eval_mobilenet_v2.yml + train.torch_pretrained (a torchvision-layout MobileNetV2 1.0 "
        f"state_dict from seeded tensors, {res['pth_bytes'] / 1e6:.1f} MB), {LIFE_EVAL_IMAGES} fake eval images at "
        f"{IMAGE_SIZE}, f32: card loss {card['eval_loss']:.7f} top-1 {card['eval_top1']:.4f}, CPU loss "
        f"{cpu['eval_loss']:.7f} top-1 {cpu['eval_top1']:.4f} (loss rel {loss_rel:.2e}, tol {TRAIN_LOSS_TOL}); "
        f"logits of the run's weights on the card vs the imported tree's Network.apply on the CPU: max |err| "
        f"{err:.3e}, max |logit| {res['max_logit']:.3e}, smallest top-2 margin {res['min_top2_margin']:.3e} "
        f"(rtol {SLICE_RTOL}, atol {SLICE_ATOL}); {card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU; K1 "
        f"launches in the card's run {card_k1} (wrapper count); the first eval batch made on the card "
        f"{'equals' if same_images else 'DIFFERS FROM'} the CPU's bit for bit")
    if (not same_images or loss_rel > TRAIN_LOSS_TOL or card["eval_top1"] != cpu["eval_top1"] or got.shape != want.shape
            or not np.all(np.abs(got - want) <= SLICE_ATOL + SLICE_RTOL * np.abs(want))):
        raise AssertionError(f"eval-only run: the card disagrees with the CPU: {res}")
    return res, pth, net


def _life_train_cfg(tmp: str, tag: str, pth: str, *extra: str):
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    return parse_cli([f"app:{LIFE_TRAIN_APP}", *LIFE_CUTS, f"train.torch_pretrained={pth}",
                      f"train.log_dir={os.path.join(tmp, 'life_' + tag)}", *extra])


def _state_diff(a, b) -> float:
    """max |a - b| over every tensor of two TrainStates (inf if a step,
    shape or structure differs)."""
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree
    from yet_another_mobilenet_series_tpu_torch.train.steps import train_state_to_dict

    fa, fb = (flatten_tree(train_state_to_dict(t)) for t in (a, b))
    if set(fa) != set(fb):
        return float("inf")
    out = 0.0
    for k, x in fa.items():
        y = fb[k]
        if x is None or y is None:
            if x is not y:
                return float("inf")
            continue
        if x.shape != y.shape or (not x.is_floating_point() and not bool((x == y).all())):
            return float("inf")
        if x.is_floating_point():
            out = max(out, float((x.float() - y.float()).abs().max()))
    return out


def _ckpt_counters() -> dict:
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry

    snap = get_registry().snapshot()
    return {k: snap.get(k, 0.0) for k in ("ckpt.restore_fallbacks", "ckpt.integrity_failures", "train.preemptions")}


def _flip_in_item(path: str) -> int:
    """Flip one bit inside the stem conv weight's bytes of a params item
    file: the file still loads, one weight changed. Returns the offset."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree

    with open(path, "rb") as f:
        blob = bytearray(f.read())
    w = flatten_tree(torch.load(path, map_location="cpu", weights_only=True))["stem/conv/w"]
    at = bytes(blob).find(w.numpy().tobytes()[:64])
    if at < 0:
        raise AssertionError(f"the stem weight's bytes are not in {path}")
    blob[at + 9] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(blob))
    if torch.equal(flatten_tree(torch.load(path, map_location="cpu", weights_only=True))["stem/conv/w"], w):
        raise AssertionError("the flipped bit did not change the weight")
    return at + 9


def phase_life_resume(device, tmp: str, pth: str) -> dict:
    """(b) apps/mobilenet_v2.yml warm-started from the .pth (train.torch_pretrained)
    at 224, cut as LIFE_CUTS: two uninterrupted runs, then a run with
    train.faults.kill_at_step whose SIGTERM handler checkpoints synchronously
    and returns ``preempted`` with preempt_marker.json written, then
    train.resume to the end with the marker consumed; final params, opt
    state, EMA and step against the uninterrupted run, bit for bit or
    within LIFE_SPREAD_FACTOR times the two uninterrupted runs' spread, under
    torch.use_deterministic_algorithms(True). (c) The preempted run's newest
    step corrupted in two copies of its log dir, one item file truncated, and
    one bit flipped inside a weight (only the digest sees it): each resume
    falls back one step, ckpt.restore_fallbacks 1 and, for the flip,
    ckpt.integrity_failures 1, and ends where the uninterrupted run does."""
    import shutil
    import warnings

    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise

    deterministic = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(), torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
    nondeterministic: set = set()
    k1_launches: dict = {}

    def run(tag, *extra):
        torch.cuda.synchronize()
        fused_depthwise.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            summary, ts, _ = train_cli.train(_life_train_cfg(tmp, tag, pth, *extra), device=str(device))
        k1_launches[f"{tag} resumed" if tag in k1_launches else tag] = fused_depthwise.launches
        nondeterministic.update(str(w.message)[:100] for w in caught if "deterministic" in str(w.message))
        return summary, ts, time.perf_counter() - t0

    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        a, ts_a, a_s = run("a")
        b, ts_b, b_s = run("b")
        spread = _state_diff(ts_a, ts_b)
        before = _ckpt_counters()
        c, _, c_s = run("c", "train.faults.enable=true", f"train.faults.kill_at_step={LIFE_KILL_AT}")
        c_dir = os.path.join(tmp, "life_c")
        marker_path = os.path.join(c_dir, train_cli.PREEMPT_MARKER_NAME)
        with open(marker_path) as f:
            marker = json.load(f)
        after_c = _ckpt_counters()
        kill_step = LIFE_KILL_AT + 1
        if not (c["preempted"] and c["step"] == kill_step and marker["step"] == kill_step
                and marker["reason"] == "SIGTERM" and after_c["train.preemptions"] == before["train.preemptions"] + 1):
            raise AssertionError(f"the preempted run: {c}, marker {marker}")
        # the corruption cases (c) start from copies of the preempted run's log dir
        for tag in ("truncated", "flipped"):
            shutil.copytree(c_dir, os.path.join(tmp, f"life_{tag}"))
        d, ts_d, d_s = run("c")
        if not (d["resumed_from"] == kill_step and d["step"] == a["step"] and not d["preempted"]
                and not os.path.exists(marker_path)):
            raise AssertionError(f"the resumed run: {d}")
        diff = _state_diff(ts_d, ts_a)
        cases = {}
        newest = os.path.join(tmp, "life_{}", "ckpt", str(kill_step), "tree", "params.pt")
        for tag in ("truncated", "flipped"):
            path = newest.format(tag)
            if tag == "truncated":
                with open(path, "rb") as f:
                    blob = f.read()
                with open(path, "wb") as f:
                    f.write(blob[: len(blob) // 2])
                where = len(blob) // 2
            else:
                where = _flip_in_item(path)
            c0 = _ckpt_counters()
            e, ts_e, e_s = run(tag)
            c1 = _ckpt_counters()
            cases[tag] = {"resumed_from": e["resumed_from"], "step": e["step"], "offset": where, "seconds": e_s,
                          "fallbacks": c1["ckpt.restore_fallbacks"] - c0["ckpt.restore_fallbacks"],
                          "integrity_failures": c1["ckpt.integrity_failures"] - c0["ckpt.integrity_failures"],
                          "diff_vs_uninterrupted": _state_diff(ts_e, ts_a)}
    finally:
        torch.use_deterministic_algorithms(deterministic[0], warn_only=deterministic[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic[2], deterministic[3]
    bar = LIFE_SPREAD_FACTOR * spread
    res = {"cuts": LIFE_CUTS, "uninterrupted": {k: a[k] for k in ("step", "checkpoints", "eval_loss", "seconds")},
           "preempted": {k: c[k] for k in ("step", "checkpoints", "preempted")}, "marker": marker,
           "resumed": {k: d[k] for k in ("resumed_from", "step", "checkpoints", "seconds")},
           "spread": spread, "diff": diff, "bit_for_bit": diff == 0.0, "bar": bar, "corrupt": cases,
           "nondeterministic_ops": sorted(nondeterministic), "run_s": {"a": a_s, "b": b_s, "c": c_s, "d": d_s},
           "k1_launches": k1_launches}
    log(f"life (b): apps/mobilenet_v2.yml warm-started from the .pth at {IMAGE_SIZE}, bf16, cut: "
        f"{' '.join(LIFE_CUTS)}; "
        f"uninterrupted runs {a['step']} steps ({a_s:.1f} s, {b_s:.1f} s), checkpoints at {a['checkpoints']}; the "
        f"killed run (train.faults.kill_at_step={LIFE_KILL_AT}) stopped at step {c['step']} with a synchronous "
        f"checkpoint (saved {c['checkpoints']}), marker {marker['reason']} at step {marker['step']}; resumed from "
        f"{d['resumed_from']} to {d['step']}, marker consumed; final params/opt state/EMA/step vs uninterrupted: "
        f"max |diff| {diff:.3e} ({'bit for bit' if diff == 0 else 'not bit for bit'}), two uninterrupted runs "
        f"{spread:.3e} (bar {LIFE_SPREAD_FACTOR}x = {bar:.3e}); deterministic algorithms on, ops that warned: "
        f"{sorted(nondeterministic) or 'none'}; K1 launches by run (wrapper count) {k1_launches}")
    for tag, r in cases.items():
        log(f"life (c) {tag} newest step ({kill_step}, params item at byte {r['offset']}): resumed from "
            f"{r['resumed_from']} to {r['step']}, ckpt.restore_fallbacks +{r['fallbacks']:.0f}, "
            f"ckpt.integrity_failures +{r['integrity_failures']:.0f}; final state vs uninterrupted max |diff| "
            f"{r['diff_vs_uninterrupted']:.3e}")
    if diff > bar:
        raise AssertionError(f"the resumed run ends {diff:.3e} from the uninterrupted one (bar {bar:.3e})")
    want_fail = {"truncated": 0, "flipped": 1}
    previous = LIFE_STEPS_PER_EPOCH * (kill_step // LIFE_STEPS_PER_EPOCH)  # the periodic save before the kill
    bad = {t: r for t, r in cases.items()
           if r["resumed_from"] != previous or r["fallbacks"] != 1 or r["integrity_failures"] != want_fail[t]
           or r["step"] != a["step"]
           or r["diff_vs_uninterrupted"] > bar}
    if bad:
        raise AssertionError(f"corrupt newest step: {bad}")
    return res


def phase_life_serve(device, tmp: str, ckpt_dir: str) -> dict:
    """(d) cli/serve.py's run() with serve.export_from=<the resumed run's
    ckpt dir> (shipped serving config: buckets 1/8/32, f32), the counts at 0
    just before and read just after: every request served, every dispatch a
    replay, K1 LIFE_PER_FORWARD launches a forward in the graphs and on the
    card's own counter (the run's, and SERVED_FORWARDS forwards of an
    engine of the bundle, K1's share of their device time from the
    profiler); logits against Network.apply of the checkpoint's EMA weights
    on the card within FOLD_ATOL."""
    tf32_off("the served logits against Network.apply at FOLD_ATOL")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.ckpt import CheckpointManager
    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import load_bundle
    from yet_another_mobilenet_series_tpu_torch.train.steps import train_state_from_dict

    bundle_dir = os.path.join(tmp, "life_bundle")
    cfg = parse_cli([f"app:{APP}", f"serve.export_from={ckpt_dir}", f"serve.bundle={bundle_dir}",
                     f"serve.requests={LIFE_SERVE_REQUESTS}", f"serve.clients={SERVE_CLIENTS}",
                     "serve.compute_dtype=float32", f"data.image_size={IMAGE_SIZE}",
                     f"train.log_dir={os.path.join(tmp, 'log_life')}"])
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    card0 = _k1_on_card()
    t0 = time.perf_counter()
    result = serve_cli.run(cfg, device=str(device))
    wall = time.perf_counter() - t0
    launches = fused_depthwise.launches
    k1 = _k1_accounting(result["graphs"], launches, LIFE_PER_FORWARD)
    k1["card"] = _k1_card_gate(card0, k1["launches"], "cli.serve.run with serve.export_from")
    captured_forwards = sum(g["key"][2] for g in result["graphs"])
    bundle = load_bundle(bundle_dir)
    log(f"life (d): cli.serve.run with serve.export_from (buckets {'/'.join(map(str, cfg.serve.buckets))}, f32): "
        f"exported step {bundle.meta['step']} (ema {bundle.meta['ema']}) -> {result['bundle']}; "
        f"{result['completed']}/{result['requests']} requests, {result['qps']:.1f} QPS, p50 {result['p50_ms']:.2f} ms, "
        f"p99 {result['p99_ms']:.2f} ms; {result['dispatches']} dispatches = {result['replays']} graph replays; K1 "
        f"{k1['launches']} launches = {k1['warm']} warm + {k1['replayed']} replayed ({LIFE_PER_FORWARD} a forward in "
        f"every graph), {k1['card']} on the card's own counter; {wall:.1f} s with the export and the captures")
    if (result["completed"] != LIFE_SERVE_REQUESTS or result["shed"] or result["rejected_full"]
            or result["dispatches"] != result["replays"] or result["bundle"] != bundle_dir or not bundle.meta["ema"]):
        raise AssertionError(f"serve.export_from: {result}")
    mgr = CheckpointManager(ckpt_dir)
    step, net, _ = mgr.restore_spec()
    ts = train_state_from_dict(mgr.restore_tree(step), device)
    engine = InferenceEngine(bundle, device=str(device), buckets=(TRAIN_CHECK_BATCH,))
    engine.warmup()
    x = np.random.RandomState(13).normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    got = engine.predict(x)
    prof = profile_served_forwards(engine, x, LIFE_PER_FORWARD, f"{SERVED_FORWARDS} served forwards of MobileNetV2")
    with torch.inference_mode():
        want = net.apply(ts.ema_params, ts.ema_state, torch.from_numpy(x).to(device), train=False).cpu().numpy()
    err = float(np.abs(got - want).max())
    res = {"k1": k1, "wrapper_launches": launches, "card_per_forward": prof["k1"] / SERVED_FORWARDS,
           "graphs_per_forward": k1["captured"] / captured_forwards,
           "profile": prof, "max_abs_err": err, "max_logit": float(np.abs(want).max()), "step": step,
           "qps": result["qps"], "p50_ms": result["p50_ms"], "p99_ms": result["p99_ms"], "wall_s": wall,
           "k1_share_of_device_time": prof["k1_us"] / prof["busy_us"]}
    log(f"life (d): served logits vs Network.apply of the checkpoint's EMA weights on the card (f32, bucket "
        f"{TRAIN_CHECK_BATCH}): max |err| {err:.3e} (atol {FOLD_ATOL}), max |logit| {res['max_logit']:.3e}; K1 "
        f"{prof['k1']} launches in {SERVED_FORWARDS} forwards on the card's own counter (the profiler kept "
        f"{prof['k1_profiled']}; the first window {prof['k1_discarded_window']} / "
        f"{prof['k1_profiled_discarded_window']}), {100 * res['k1_share_of_device_time']:.1f}% of the forwards' "
        f"device time")
    if got.shape != want.shape or not np.isfinite(got).all() or err > FOLD_ATOL:
        raise AssertionError(f"the exported checkpoint's served logits differ by {err:.3e}")
    return res


def phase_life_costs(device, tmp: str, pth: str) -> dict:
    """(f) The checkpoint's costs at (b)'s shape, for a later PR: a save's
    enqueue and its wait (first and steady), the snapshot as a plain .cpu()
    beside it, the bytes on disk, a restore (spec, then the tree onto the
    card), and the step time with and without a save in flight."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.ckpt import CheckpointManager
    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.data import pipeline as data_lib
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree
    from yet_another_mobilenet_series_tpu_torch.parallel import make_mesh
    from yet_another_mobilenet_series_tpu_torch.train.steps import train_state_to_dict
    from yet_another_mobilenet_series_tpu_torch.utils.logging import Logger

    cfg = _life_train_cfg(tmp, "costs", pth)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, fake_num_classes=cfg.model.num_classes))
    net = get_model(cfg.model, IMAGE_SIZE)
    trainer, ts = train_cli._init_or_warm_start(cfg, net, make_mesh(device), Logger(enabled=False))
    gen = torch.Generator(device=device).manual_seed(0)
    batches = data_lib.make_train_source(cfg.data, cfg.train.batch_size, 0, device=device)

    def steps_ms(n: int, during=None) -> float:
        nonlocal ts
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if during is not None:
            during()
        for _ in range(n):
            ts, _ = trainer.train_step(ts, next(batches), gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    steps_ms(3)  # warm
    mgr = CheckpointManager(os.path.join(tmp, "life_costs_ckpt"), max_to_keep=2)
    saves = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(i + 1, trainer.net, ts, extra={"epoch": 0.0}, items={"generator": gen.get_state()})
        t1 = time.perf_counter()
        mgr.wait()
        saves.append({"enqueue_s": t1 - t0, "wait_s": time.perf_counter() - t1})
    step_dir = os.path.join(tmp, "life_costs_ckpt", "3")
    nbytes = sum(os.path.getsize(os.path.join(root, f)) for root, _, files in os.walk(step_dir) for f in files)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = {k: v.cpu() for k, v in flatten_tree(train_state_to_dict(ts)).items() if v is not None}
    cpu_snapshot_s = time.perf_counter() - t0
    del host
    target = train_state_to_dict(trainer.init_state(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.restore_spec(3)
    t1 = time.perf_counter()
    mgr.restore_tree(3, target)
    torch.cuda.synchronize()
    restore = {"spec_s": t1 - t0, "tree_s": time.perf_counter() - t1}
    plain_ms = steps_ms(LIFE_TIMED_STEPS)
    write = {}

    def save_in_flight():
        write["t0"] = time.perf_counter()
        mgr.save(4, trainer.net, ts, extra={"epoch": 0.0}, items={"generator": gen.get_state()})

    in_flight_ms = steps_ms(LIFE_TIMED_STEPS, save_in_flight)
    t_done = time.perf_counter()
    mgr.wait()
    write["done_after_steps_s"] = time.perf_counter() - t_done
    write["total_s"] = time.perf_counter() - write.pop("t0")
    plain_after_ms = steps_ms(LIFE_TIMED_STEPS)
    mgr.close()
    evals = time_life_evals(trainer, ts, cfg, device)
    res = {"saves": saves, "bytes": nbytes, "cpu_snapshot_s": cpu_snapshot_s, "restore": restore,
           "step_ms": plain_ms, "step_ms_after": plain_after_ms, "step_ms_save_in_flight": in_flight_ms,
           "save_in_flight": write, "steps": LIFE_TIMED_STEPS, "batch": cfg.train.batch_size, "eval": evals}
    enqueue_ms = ", ".join(f"{r['enqueue_s'] * 1e3:.1f}" for r in saves)
    wait_ms = ", ".join(f"{r['wait_s'] * 1e3:.1f}" for r in saves)
    log(f"life (f) checkpoint costs (MobileNetV2 1.0 at {IMAGE_SIZE}, bf16, batch {cfg.train.batch_size}): save "
        f"enqueue {enqueue_ms} ms and wait {wait_ms} ms (three saves; the pinned snapshot, then the write on its "
        f"thread); a plain .cpu() snapshot {cpu_snapshot_s * 1e3:.1f} ms; {nbytes / 1e6:.2f} MB a checkpoint; "
        f"restore spec {restore['spec_s'] * 1e3:.1f} ms, tree onto the card {restore['tree_s'] * 1e3:.1f} ms")
    log(f"life (f) step time: {plain_ms:.2f} ms a step without a save ({plain_after_ms:.2f} after), "
        f"{in_flight_ms:.2f} ms with a save enqueued before the first of {LIFE_TIMED_STEPS} steps (the write took "
        f"{write['total_s'] * 1e3:.1f} ms, {write['done_after_steps_s'] * 1e3:.1f} ms of it after the steps)")
    return res


def time_life_evals(trainer, ts, cfg, device) -> dict:
    """One EMA eval pass (cli/train.py ``evaluate``) of LIFE_EVAL_TIMED_IMAGES
    fake images at eval batch LIFE_EVAL_TIMED_BATCH, and the eval stream
    alone, with three ways of making the eval noise: the port's integer hash
    on the device (``eval_noise``), one device ``randn`` a batch (what the
    port did before it had one eval set on every device: fast, but the
    card's images were not the CPU's) and a per-image CPU draw copied to the
    card (the first way to one eval set). Two rounds, the first warm; the
    second's ms."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.data import pipeline as data_lib

    class DeviceRandn(data_lib.FakeImages):
        def eval_batches(self, local_batch, rank=0, world=1):
            gen = torch.Generator(device=self.device).manual_seed(data_lib.EVAL_NOISE_SEED)
            for start in range(0, self.cfg.fake_eval_size, local_batch):
                rows = min(local_batch, self.cfg.fake_eval_size - start)
                labels = (torch.arange(start, start + rows, device=self.device) % self.num_classes).to(torch.int32)
                yield {"image": self._images(labels, gen), "label": labels}

    class HostPerImage(data_lib.FakeImages):
        def eval_batches(self, local_batch, rank=0, world=1):
            gen = torch.Generator()
            for start in range(0, self.cfg.fake_eval_size, local_batch):
                rows = min(local_batch, self.cfg.fake_eval_size - start)
                noise = torch.empty((rows, *self.templates.shape[1:]), pin_memory=self.device.type == "cuda")
                for r in range(rows):  # 3: the salt of the eval images' seeds then
                    gen.manual_seed(data_lib.stream_seed(3, data_lib.EVAL_NOISE_SEED, start + r))
                    noise[r].normal_(generator=gen)
                labels = (torch.arange(start, start + rows, device=self.device) % self.num_classes).to(torch.int32)
                noise = noise.to(self.device, non_blocking=True)
                yield {"image": self.templates[labels.long()] + data_lib.NOISE_SCALE * noise, "label": labels}

    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, fake_eval_size=LIFE_EVAL_TIMED_IMAGES),
                              train=dataclasses.replace(cfg.train, eval_batch_size=LIFE_EVAL_TIMED_BATCH))
    sources = {"device_hash": data_lib.FakeImages(cfg.data, device), "device_randn": DeviceRandn(cfg.data, device),
               "host_per_image": HostPerImage(cfg.data, device)}
    out: dict = {}
    for _ in range(2):
        for tag, fake in sources.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _batch in fake.eval_batches(LIFE_EVAL_TIMED_BATCH):
                pass
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            m = train_cli.evaluate(trainer, ts, cfg, fake)
            torch.cuda.synchronize()
            out[tag] = {"stream_ms": (t1 - t0) * 1e3, "eval_pass_ms": (time.perf_counter() - t1) * 1e3,
                        "n": m["n"]}
    if any(r["n"] != LIFE_EVAL_TIMED_IMAGES for r in out.values()):
        raise AssertionError(f"the timed eval passes: {out}")
    log(f"life (f) eval pass (MobileNetV2 1.0 at {IMAGE_SIZE}, EMA weights, {cfg.train.compute_dtype}, "
        f"{LIFE_EVAL_TIMED_IMAGES} images at batch {LIFE_EVAL_TIMED_BATCH}), by how the eval noise is made: "
        + "; ".join(f"{tag} {r['eval_pass_ms']:.1f} ms a pass, the stream alone {r['stream_ms']:.1f} ms"
                    for tag, r in out.items()))
    return out


def phase_life_report(log_dir: str) -> dict:
    """(b) ``python -m ...obs.report`` over the preempted and resumed run's
    log dir: its metrics rows, the registry, the training books (the
    restore of the resume) and the cost of its step."""
    text = _obs_tool("report", log_dir)
    _check_sections("obs.report of phase 11's resumed run", text, (
        "## metrics.jsonl (", "last train/loss = ", "## registry snapshot (",
        "## training (host syncs / checkpoints / input)", "checkpoints: saves = ",
        "## device (compile / cost / memory)", "[train_step]"))
    books = [line.strip() for line in text.splitlines() if line.startswith(("  steps = ", "  checkpoints: "))]
    log("life (b): obs.report of the resumed run: " + "; ".join(books))
    return {"lines": len(text.splitlines()), "books": books}


def phase_life(device, tmp: str, rates, arm: str | None = None) -> dict:
    """Phase 11, the life of a run on MobileNetV2 1.0 at 224; with ``arm``,
    that arm of the serve bench (``start_serve_arm``) runs beside (a)-(c),
    whose checks are exact, and ends before the timed (d)-(f)."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.config import ModelConfig

    t0 = time.perf_counter()
    lap = _laps("11")
    out = {}
    beside = start_serve_arm(arm) if arm else None
    try:
        out["eval"], pth, _ = phase_life_eval(device, tmp)
        torch.cuda.empty_cache()
        lap("(a) eval-only, card and CPU")
        out["resume"] = phase_life_resume(device, tmp, pth)
        lap("(b)-(c) six training runs")
        if beside is not None:
            out["serve_arm"] = finish_serve_arm(arm, beside, "phase 11 (a)-(c)")
            lap(f"the serve bench's --{arm} arm, the rest of it")
    finally:
        if beside is not None:
            _bench_stop(beside)
    out["report"] = phase_life_report(os.path.join(tmp, "life_c"))
    lap("(b) obs.report")
    out["serve"] = phase_life_serve(device, tmp, os.path.join(tmp, "life_c", "ckpt"))
    torch.cuda.empty_cache()
    lap("(d) serve.export_from")
    net = get_model(ModelConfig(arch="mobilenet_v2"), image_size=IMAGE_SIZE)
    if sum(1 for blk in net.blocks for _ in blk._branches()) != LIFE_PER_FORWARD:
        raise AssertionError("MobileNetV2 1.0 has not 17 depthwise stages")
    out["kernel_checks"] = check_net_stages(device, {"mobilenet_v2": net}, batches=BUCKETS)
    out["kernel_times"] = time_stages(device, rates, mbv3_depthwise_shapes(32, "mobilenet_v2")[1])
    lap("(e) K1 at MobileNetV2's stages")
    out["costs"] = phase_life_costs(device, tmp, pth)
    lap("(f) costs")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 11 (the life of a run) took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 12: data parallel and the grouped train step
# ---------------------------------------------------------------------------

# MobileNetV3-Large 1.0 at 224 (apps/mobilenet_v3_large.yml, bf16), cut to
# DP_STEPS steps at batch DP_BATCH and a small eval
DP_BATCH = 256
DP_STEPS = 12
DP_CUTS = [f"train.batch_size={DP_BATCH}", f"data.fake_train_size={DP_BATCH * DP_STEPS}", "train.epochs=1",
           "train.log_every=4", f"data.fake_eval_size={DP_BATCH}", f"train.eval_batch_size={DP_BATCH}"]
DP_TIMEOUT_S = 300
# (b) ZeRO against the replicated update, both clipping at this global norm
ZERO_CLIP = 1.0
# (b)'s bar on max |diff| of the final params, ZeRO against replicated: the
# clip's norm sums its squares over the flat shards, in another order than
# over the leaves. Measured 0.0 (bit for bit, params, BN state, EMA and both
# optimizer buffers) on an NVIDIA H100 80GB HBM3 at 700 W.
ZERO_TOL = 1e-6
# (c) two gloo ranks on the one card: MobileNetV3-Large 1.0 at 224, f32, TF32
# off, dropout off (the ranks draw their own noise), SyncBN, one step at
# this global batch against one process; the repository's f32 bar
GLOO_BATCH = 64
GLOO_RTOL, GLOO_ATOL = 1e-4, 1e-5
# (d) the grouped step: K steps in one CUDA graph against K eager steps
GROUP_K = 4
GROUP_BATCH = 256
GROUP_TIMED_GROUPS = 3
# (e) the CLI, grouped, with the replica check, killed and resumed
GROUP_CLI_STEPS_PER_EPOCH = 8
GROUP_CLI_KILL_AT = 7  # the 8th batch: the SIGTERM lands in the second group


def _dp_cli(tmp: str, tag: str, *extra: str) -> list[str]:
    return [f"app:{TRAIN_APP}", "data.dataset=fake", f"data.image_size={IMAGE_SIZE}", *DP_CUTS,
            f"train.log_dir={os.path.join(tmp, 'dp_' + tag)}", *extra]


def _last_checkpoint(log_dir: str) -> dict:
    from yet_another_mobilenet_series_tpu_torch.ckpt import CheckpointManager

    mgr = CheckpointManager(os.path.join(log_dir, "ckpt"))
    try:
        return mgr.restore_tree(mgr.latest_step())
    finally:
        mgr.close()


def _tree_diff(a, b) -> float:
    """max |a - b| over two trees of tensors (inf if their keys or shapes differ)."""
    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree

    fa = flatten_tree(a) if isinstance(a, dict) else {"": a}
    fb = flatten_tree(b) if isinstance(b, dict) else {"": b}
    if set(fa) != set(fb):
        return float("inf")
    out = 0.0
    for k, x in fa.items():
        y = fb[k]
        if x is None or y is None:
            if x is not y:
                return float("inf")
            continue
        if x.shape != y.shape:
            return float("inf")
        out = max(out, float((x.cpu().double() - y.cpu().double()).abs().max()) if x.numel() else 0.0)
    return out


def _step_ms(log_dir: str, batch: int) -> list[float]:
    """ms per step of each log window after the first (images/s of the rows)."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [1e3 * batch / r["train/images_per_sec"] for r in rows if "train/images_per_sec" in r][1:]


def _dp_torchrun_start(tmp: str):
    """(a)'s run through ``python -m torch.distributed.run --standalone
    --nproc_per_node 1`` with dist.multihost=true (NCCL, a world of 1),
    started: it is a process of its own by what it checks (torchrun's env://
    rendezvous), and its start overlaps (a)'s run without a group and (c)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out_path, err_path = os.path.join(tmp, "dp_torchrun.out"), os.path.join(tmp, "dp_torchrun.err")
    with open(out_path, "w") as out_f, open(err_path, "w") as err_f:
        proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                                 "-m", "yet_another_mobilenet_series_tpu_torch.cli.train",
                                 *_dp_cli(tmp, "torchrun", "dist.multihost=true")],
                                cwd=REPO, env=env, stdout=out_f, stderr=err_f, start_new_session=True)
    return proc, time.perf_counter(), out_path, err_path


def _kill_group(proc) -> None:
    """Kill a process started with ``start_new_session=True`` and every
    process of its group (torchrun's worker with its agent), and reap it."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()


def _dp_plain(tmp: str) -> dict:
    """(a)'s run without a process group: ``cli/train.py``'s ``main`` (as
    ``python -m ...cli.train`` runs it) in this process, before its NCCL
    world of 1 exists."""
    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli

    t0 = time.perf_counter()
    train_cli.main(_dp_cli(tmp, "plain"))
    log_dir = os.path.join(tmp, "dp_plain")
    return {"wall_s": time.perf_counter() - t0, "ms_per_step": _step_ms(log_dir, DP_BATCH),
            "tree": _last_checkpoint(log_dir)}


def phase_dp_torchrun(tmp: str, plain: dict, started) -> dict:
    """(a) apps/mobilenet_v3_large.yml (1.0 at 224, bf16) at batch DP_BATCH,
    DP_STEPS steps, without a process group (``_dp_plain``) and through
    torchrun (``_dp_torchrun_start``): the final checkpoints bit for bit
    equal, item by item. The two runs and (c) overlap on the card, so their
    ms per step are not a clean reading (phase 12 (d) and the train bench
    time the step alone)."""
    proc, t0, out_path, err_path = started
    try:
        rc = proc.wait(timeout=max(1.0, DP_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        raise
    wall = time.perf_counter() - t0
    with open(out_path) as f:
        stdout = f.read()
    stderr = _tail(err_path)
    if rc != 0:
        raise AssertionError(f"dp (a) torchrun: exit {rc}\n{stdout[-2000:]}\n{stderr[-3000:]}")
    log_dir = os.path.join(tmp, "dp_torchrun")
    runs = {"plain": plain,
            "torchrun": {"wall_s": wall, "ms_per_step": _step_ms(log_dir, DP_BATCH), "tree": _last_checkpoint(log_dir),
                         "first_line": stdout.splitlines()[0] if stdout else ""}}
    a, b = runs["plain"]["tree"], runs["torchrun"]["tree"]
    diffs = {k: _tree_diff(a[k], b[k]) for k in sorted(a) if a[k] is not None or b[k] is not None}
    bit_equal = all(v == 0.0 for v in diffs.values())
    res = {tag: {k: v for k, v in r.items() if k != "tree"} for tag, r in runs.items()}
    res.update(diffs=diffs, bit_equal=bit_equal)
    log(f"dp (a) on {card_line()}: apps/mobilenet_v3_large.yml 1.0 at {IMAGE_SIZE}, bf16, batch {DP_BATCH}, "
        f"{DP_STEPS} steps: no process group (cli.train's main in this process) {res['plain']['ms_per_step']} ms per "
        f"step ({res['plain']['wall_s']:.1f} s); torchrun world of 1 (NCCL, a process of its own, started first) "
        f"{res['torchrun']['ms_per_step']} ms per step ({res['torchrun']['wall_s']:.1f} s); the runs overlap each "
        f"other and (c) on the card, so these step times are not clean; its first line: "
        f"{res['torchrun']['first_line'][-90:]}; final checkpoint items max |diff| {diffs} "
        f"({'bit for bit' if bit_equal else 'NOT bit for bit'})")
    if not bit_equal or "rank 0 of 1 (nccl)" not in res["torchrun"]["first_line"]:
        raise AssertionError(f"dp (a): the world of 1 differs from the run without a group: {res}")
    return res


def _world_of_one(device):
    """A NCCL world of 1 in this process (the env:// rendezvous torchrun
    would set up), its mesh, and whether this call made the group."""
    import torch.distributed as dist

    from yet_another_mobilenet_series_tpu_torch.cli.train import _free_port
    from yet_another_mobilenet_series_tpu_torch.parallel import init_mesh

    made = not dist.is_initialized()
    if made:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0", WORLD_SIZE="1",
                          LOCAL_RANK="0")
    return init_mesh(str(device)), made


def phase_dp_zero(device, tmp: str, mesh) -> dict:
    """(b) the same cut of apps/mobilenet_v3_large.yml through cli/train.py's
    train() in a NCCL world of 1 (dist.multihost=true), clipping at
    ZERO_CLIP: dist.shard_optimizer=true against the replicated update; the
    final params, BN state and EMA within ZERO_TOL, the gathered optimizer
    state beside them."""
    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.parallel import zero

    out = {}
    for tag, extra in (("replicated", []), ("zero", ["dist.shard_optimizer=true"])):
        cfg = parse_cli(_dp_cli(tmp, "b_" + tag, "dist.multihost=true", f"optim.grad_clip_norm={ZERO_CLIP}", *extra))
        t0 = time.perf_counter()
        summary, ts, _ = train_cli.train(cfg, device=str(device))
        out[tag] = (summary, ts, time.perf_counter() - t0)
    (rs, rts, r_s), (zs, zts, z_s) = out["replicated"], out["zero"]
    zopt = zero.gather_opt_state(zts.opt_state, zts.params, mesh)
    diffs = {"params": _tree_diff(zts.params, rts.params), "state": _tree_diff(zts.state, rts.state),
             "ema_params": _tree_diff(zts.ema_params, rts.ema_params),
             "opt_nu": _tree_diff(zopt["nu"], rts.opt_state["nu"]),
             "opt_trace": _tree_diff(zopt.get("trace", {}), rts.opt_state.get("trace", {}))}
    norms = ([row["grad_norm"] for row in rs["log"]], [row["grad_norm"] for row in zs["log"]])
    res = {"diffs": diffs, "tol": ZERO_TOL, "grad_norms": {"replicated": norms[0], "zero": norms[1]},
           "seconds": {"replicated": r_s, "zero": z_s}, "world": zs["world"], "finite": zs["finite_steps"]}
    log(f"dp (b): ZeRO against the replicated update, NCCL world of 1, clip {ZERO_CLIP}, {DP_STEPS} bf16 steps at "
        f"batch {DP_BATCH}: max |diff| {diffs} (tol {ZERO_TOL} on params); log-point grad norms {norms[0]} / "
        f"{norms[1]}; {r_s:.1f} s / {z_s:.1f} s")
    if (diffs["params"] > ZERO_TOL or zs["finite_steps"] != DP_STEPS or zs["world"] != 1
            or not all(v < float("inf") for v in diffs.values())):
        raise AssertionError(f"dp (b): ZeRO differs from the replicated update: {res}")
    return res


def _gloo_rank(rank: int, init_method: str, ref_path: str, results) -> None:
    """(c) one of two gloo ranks on the one card: the step on its half of the
    global batch, held against the one-process reference; then the replica
    check, and a one-ulp drift planted on rank 1."""
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        tf32_off("two gloo ranks held at the float32 bar")
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=2)
        from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree
        from yet_another_mobilenet_series_tpu_torch.parallel import dp, make_mesh

        mesh = make_mesh("cuda:0", dist.group.WORLD)
        ref = torch.load(ref_path, map_location="cuda:0", weights_only=False)
        net, cfg, opt, lr_fn, ts, batch = _gloo_setup(torch.device("cuda", 0))
        local = GLOO_BATCH // 2
        mine = {k: v[rank * local: (rank + 1) * local] for k, v in batch.items()}
        step = dp.make_dp_train_step(net, cfg, opt, lr_fn, mesh)
        new, m = step(ts, mine, dp.rank_generator(0, mesh))
        out = {"rank": rank, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        ok = True
        for field in ("params", "state", "opt_state"):
            fa, fb = flatten_tree(getattr(new, field)), flatten_tree(ref[field])
            out[field] = max(float((fa[k] - fb[k]).abs().max()) for k in fb)
            ok = ok and all(bool(torch.allclose(fa[k], fb[k], rtol=GLOO_RTOL, atol=GLOO_ATOL)) for k in fb)
        out["allclose"] = ok
        check = dp.make_replica_sync_check(mesh)
        out["check"] = float(check(new.params))
        drifted = flatten_tree(new.params)
        leaf = drifted["classifier/w"]
        if rank == 1:
            leaf.view(-1)[0] = torch.nextafter(leaf.view(-1)[0], torch.tensor(float("inf"), device=leaf.device))
        out["planted"] = float(check(new.params))
        out["one_ulp"] = float((torch.nextafter(leaf.view(-1)[0], torch.tensor(float("inf"), device=leaf.device))
                                - leaf.view(-1)[0]).abs())
        results.put(out)
        dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 — reported to the parent
        results.put({"rank": rank, "error": f"{type(e).__name__}: {e}"})
        raise


def _gloo_setup(device):
    """(c)'s network, config, optimizer, initial state and global batch."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.train import optim, schedules, steps

    cfg = parse_cli([f"app:{TRAIN_APP}", "data.dataset=fake", f"data.image_size={IMAGE_SIZE}",
                     "train.compute_dtype=float32", "model.dropout=0.0", "schedule.warmup_epochs=0",
                     "dist.sync_bn=true", f"train.batch_size={GLOO_BATCH}"])
    net = get_model(cfg.model, IMAGE_SIZE)
    lr_fn = schedules.make_lr_schedule(cfg.schedule, GLOO_BATCH, 1, 1)
    opt = optim.make_optimizer(cfg.optim, lr_fn, net.init(torch.Generator().manual_seed(0))[0])
    ts = steps.init_train_state(net, cfg, opt, torch.Generator().manual_seed(0), device=device)
    rng = np.random.RandomState(3)
    x = rng.normal(0, 1, (GLOO_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    y = (np.arange(GLOO_BATCH) * 37 % cfg.model.num_classes).astype(np.int32)
    return net, cfg, opt, lr_fn, ts, {"image": torch.from_numpy(x).to(device), "label": torch.from_numpy(y).to(device)}


def phase_dp_gloo(device, tmp: str) -> dict:
    """(c) two ranks on the one card over an explicit gloo group of CUDA
    tensors, calling parallel/dp.py directly: one f32 SyncBN step of
    MobileNetV3-Large 1.0 at 224 at global batch GLOO_BATCH against one
    process at that batch (GLOO_RTOL/GLOO_ATOL, TF32 off); the replica check
    0.0, then a one-ulp drift planted in one leaf on rank 1, which it reads."""
    import multiprocessing

    import torch

    from yet_another_mobilenet_series_tpu_torch.cli.train import _free_port
    from yet_another_mobilenet_series_tpu_torch.train import steps

    tf32_off("one float32 step, two gloo ranks against one process")
    net, cfg, opt, lr_fn, ts, batch = _gloo_setup(device)
    new, m = steps.make_train_step(net, cfg, opt, lr_fn)(ts, batch, torch.Generator(device=device).manual_seed(0))
    ref_path = os.path.join(tmp, "gloo_ref.pt")
    torch.save({"params": new.params, "state": new.state, "opt_state": {k: v for k, v in new.opt_state.items()
                                                                         if k != "count"}}, ref_path)
    ref_loss = float(m["loss"])
    del new, ts
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_gloo_rank, args=(r, init, ref_path, results)) for r in range(2)]
    for p in procs:
        p.start()
    outs = []
    try:
        for _ in range(2):
            outs.append(results.get(timeout=DP_TIMEOUT_S))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    outs.sort(key=lambda o: o["rank"])
    res = {"ranks": outs, "reference_loss": ref_loss, "wall_s": wall, "rtol": GLOO_RTOL, "atol": GLOO_ATOL}
    log(f"dp (c): two gloo ranks on one card, MobileNetV3-Large 1.0 at {IMAGE_SIZE}, f32, SyncBN, global batch "
        f"{GLOO_BATCH}: against one process (loss {ref_loss:.7f}): " + "; ".join(
            f"rank {o['rank']} loss {o.get('loss', float('nan')):.7f}, max |diff| params {o.get('params', -1):.2e} "
            f"BN state {o.get('state', -1):.2e} opt {o.get('opt_state', -1):.2e}, allclose {o.get('allclose')}, "
            f"replica check {o.get('check')}, after a one-ulp drift on rank 1 {o.get('planted')} "
            f"(the ulp {o.get('one_ulp')})" for o in outs) + f"; {wall:.1f} s with the spawns")
    bad = [o for o in outs if "error" in o or not o["allclose"] or o["check"] != 0.0 or not o["planted"] > 0.0]
    if bad or len(outs) != 2:
        raise AssertionError(f"dp (c): {bad or outs}")
    return res


def _grouped_case(device, mesh, cfg, net, deterministic: bool) -> dict:
    """K=GROUP_K steps as one CUDA graph against K eager steps from one state,
    two groups in a row: the states and the metrics compared; the host syncs
    of a replay counted. With ``deterministic`` off the eager and grouped
    steps are timed instead, with the graph's kernels and peak memory."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.data import pipeline as data_lib
    from yet_another_mobilenet_series_tpu_torch.parallel import dp

    trainer = train_cli.Trainer(cfg, net, mesh=mesh)
    ts0 = trainer.init_state(cfg.train.seed)
    src = data_lib.make_train_source(cfg.data, trainer.local_batch, cfg.train.seed, device=device)
    groups = [[next(src) for _ in range(GROUP_K)] for _ in range(2 if deterministic else 1 + GROUP_TIMED_GROUPS)]

    def eager(ts, batches, gen):
        ms = []
        for b in batches:
            ts, m = trainer.train_step(ts, b, gen)
            if trainer.prune_event is not None:
                masks, rho = trainer.prune_event(ts.params, ts.masks, ts.rho_mult, ts.step)
                ts = ts.replace(masks=masks, rho_mult=rho)
            ms.append(m)
        return ts, ms

    grouped = dp.make_grouped_train_step(trainer.train_step, GROUP_K, trainer.prune_event, mesh=mesh)
    if deterministic:
        gen_e, gen_g = (dp.rank_generator(cfg.train.seed, mesh) for _ in range(2))
        te, tg, diffs, metric_diffs = ts0, ts0, [], []
        for batches in groups:
            te, me = eager(te, batches, gen_e)
            tg, mg = grouped(tg, batches, gen_g)
            torch.cuda.synchronize()
            diffs.append(_state_diff(te, tg))
            metric_diffs.append(max(abs(float(a[k]) - float(b[k])) for a, b in zip(me, mg) for k in a))
        (tg, _), seen = _record_syncs(lambda: grouped(tg, groups[0], gen_g))
        torch.cuda.synchronize()
        # the sync debug mode's own notice when it is switched on is no sync
        syncs = [(msg, stack) for msg, stack in seen if "synchronizing" in msg]
        alive = None
        if trainer.prune_event is not None:
            from yet_another_mobilenet_series_tpu_torch.nas import masking

            s = masking.mask_summary(net, te.masks)
            alive = (s["alive_atoms"], s["total_atoms"])
        return {"mode": grouped.mode, "state_diffs": diffs, "metric_diffs": metric_diffs,
                "syncs_per_replay": len(syncs),
                "sync_sites": sorted({msg for msg, _ in syncs})[:5], "alive_atoms": alive}
    gen = dp.rank_generator(cfg.train.seed, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    te, _ = eager(ts0, groups[0], gen)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated(device) / 1e9
    t0 = time.perf_counter()
    for batches in groups[1:]:
        te, _ = eager(te, batches, gen)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / (GROUP_K * GROUP_TIMED_GROUPS)
    del te
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    tg, _ = grouped(ts0, groups[0], gen)  # the capture, then the first replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    grouped_peak = torch.cuda.max_memory_allocated(device) / 1e9
    t0 = time.perf_counter()
    for batches in groups[1:]:
        tg, _ = grouped(tg, batches, gen)
    torch.cuda.synchronize()
    grouped_ms = (time.perf_counter() - t0) * 1e3 / (GROUP_K * GROUP_TIMED_GROUPS)
    state = {"tg": tg}

    def replay():
        state["tg"], _ = grouped(state["tg"], groups[1], gen)

    prof, seen, card, wall_us = _profiled_windows(replay, 1)
    for i, (n_card, n_seen) in enumerate(zip(card, seen)):
        # the training forward has no folded stage: a replay runs no K1
        _k1_check(n_card, 0, f"a grouped replay of {GROUP_K} train steps, profiler window {i + 1}", n_seen)
    kernels = _device_kernels(prof)
    busy_us = sum(us for _, us, _ in kernels)
    return {"mode": grouped.mode, "eager_ms_per_step": eager_ms, "grouped_ms_per_step": grouped_ms,
            "capture_and_first_replay_s": capture_s, "kernels_per_replay": sum(c for _, _, c in kernels),
            "k1_per_replay": card[1],
            "replay_busy_share": busy_us / wall_us, "eager_peak_gb": eager_peak, "grouped_peak_gb": grouped_peak}


def phase_grouped(device, tmp: str, mesh, searched_path: str | None = None) -> dict:
    """(d) the grouped step, K=GROUP_K as one CUDA graph: MobileNetV3-Large 1.0
    at 224, bf16, batch GROUP_BATCH, and apps/atomnas_a_search.yml's supernet
    with the prune event firing inside the group (prune.mask_interval=2). In
    the NCCL world of 1 (its collectives captured), under deterministic
    algorithms, two groups against K eager steps each (params, BN state,
    optimizer state, EMA, masks, rho_mult, step: bit for bit) and 0 host
    syncs in a replay; then in one process without a group, as a run on one
    card trains, with them off: ms per step eager against grouped, the
    kernels of one replay (torch.profiler) and peak memory; the same times
    for phase 8's searched net (``searched_path``), whose eager step
    followed the host."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.models import get_model
    from yet_another_mobilenet_series_tpu_torch.parallel import make_mesh

    cases = {
        "mobilenet_v3_large": parse_cli(_dp_cli(tmp, "d", "dist.multihost=true", f"train.batch_size={GROUP_BATCH}")),
        "atomnas_supernet": _search_cfg(tmp, "grouped", "dist.multihost=true",
                                        f"train.batch_size={GROUP_BATCH}", "prune.mask_interval=2",
                                        f"prune.gamma_threshold={SEARCH_GAMMA_THRESHOLD}",
                                        f"data.fake_train_size={GROUP_BATCH * 16}"),
    }
    if searched_path is not None:
        cases["searched"] = _search_cfg(tmp, "grouped_searched", f"model.network_spec={searched_path}",
                                        f"train.batch_size={GROUP_BATCH}", f"data.fake_train_size={GROUP_BATCH * 16}")
    saved = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    res = {}
    for name, cfg in cases.items():
        net = get_model(cfg.model, IMAGE_SIZE)
        if name == "searched":  # times only: the supernet's groups hold the event and the masks
            res[name] = {"timing": _grouped_case(device, make_mesh(device), cfg, net, deterministic=False)}
            t = res[name]["timing"]
            log(f"grouped (d) the searched net ({searched_path}), bf16, batch {GROUP_BATCH}, K={GROUP_K}, "
                f"{t['mode']}, one process: eager {t['eager_ms_per_step']:.2f} ms per step, grouped "
                f"{t['grouped_ms_per_step']:.2f} ms; {t['kernels_per_replay']} kernels a replay "
                f"({100 * t['replay_busy_share']:.1f}% of its wall busy); peak {t['eager_peak_gb']:.2f} GB eager, "
                f"{t['grouped_peak_gb']:.2f} GB grouped")
            continue
        try:
            torch.use_deterministic_algorithms(True, warn_only=True)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
            check = _grouped_case(device, mesh, cfg, net, deterministic=True)
        finally:
            torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2], saved[3]
        torch.cuda.empty_cache()
        timing = _grouped_case(device, make_mesh(device), cfg, net, deterministic=False)
        torch.cuda.empty_cache()
        res[name] = {"check": check, "timing": timing}
        log(f"grouped (d) {name} 1.0 at {IMAGE_SIZE}, bf16, batch {GROUP_BATCH}, K={GROUP_K}, {check['mode']} "
            f"(NCCL world of 1), on {card_line()}: against {GROUP_K} eager steps, two groups, state max |diff| "
            f"{check['state_diffs']}, metrics {check['metric_diffs']} (deterministic algorithms); host syncs in a "
            f"replay {check['syncs_per_replay']} {check['sync_sites']}; alive atoms {check['alive_atoms']}; one "
            f"process: eager {timing['eager_ms_per_step']:.2f} ms per step, grouped "
            f"{timing['grouped_ms_per_step']:.2f} ms "
            f"per step; {timing['kernels_per_replay']} kernels a replay ({100 * timing['replay_busy_share']:.1f}% "
            f"of its wall busy); capture + first replay {timing['capture_and_first_replay_s']:.2f} s; peak "
            f"{timing['eager_peak_gb']:.2f} GB eager, {timing['grouped_peak_gb']:.2f} GB grouped")
        if (check["mode"] != "cuda graph" or any(d != 0.0 for d in check["state_diffs"])
                or check["syncs_per_replay"] != 0):
            raise AssertionError(f"grouped (d) {name}: {check}")
        if name == "atomnas_supernet" and not check["alive_atoms"][0] < check["alive_atoms"][1]:
            raise AssertionError(f"grouped (d): no prune event fired inside the group: {check}")
    return res


def phase_grouped_cli(device, tmp: str) -> dict:
    """(e) cli/train.py's train() in the NCCL world of 1 with
    train.steps_per_dispatch=GROUP_K and train.param_checksum_every=GROUP_K,
    MobileNetV3-Large 1.0 at 224, bf16, batch GROUP_BATCH, two epochs of
    GROUP_CLI_STEPS_PER_EPOCH steps with a checkpoint each, under
    deterministic algorithms: uninterrupted; killed at the second group
    (train.faults.kill_at_step, a synchronous checkpoint); resumed to the
    end: the resumed state bit for bit the uninterrupted one's, every
    replica check 0.0, the grouped step a CUDA graph."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    def cfg(tag, *extra):
        return parse_cli([f"app:{TRAIN_APP}", "data.dataset=fake", f"data.image_size={IMAGE_SIZE}",
                          "dist.multihost=true", f"train.batch_size={GROUP_BATCH}",
                          f"data.fake_train_size={GROUP_BATCH * GROUP_CLI_STEPS_PER_EPOCH}", "train.epochs=2",
                          "train.checkpoint_every_epochs=1", f"train.log_every={GROUP_K}",
                          f"train.steps_per_dispatch={GROUP_K}", f"train.param_checksum_every={GROUP_K}",
                          f"data.fake_eval_size={GROUP_BATCH}", f"train.eval_batch_size={GROUP_BATCH}",
                          f"train.log_dir={os.path.join(tmp, 'grouped_cli_' + tag)}", *extra])

    saved = (torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        t0 = time.perf_counter()
        a, ts_a, _ = train_cli.train(cfg("a"), device=str(device))
        a_s = time.perf_counter() - t0
        killed = cfg("b", "train.faults.enable=true", f"train.faults.kill_at_step={GROUP_CLI_KILL_AT}")
        b, _, _ = train_cli.train(killed, device=str(device))
        c, ts_c, _ = train_cli.train(cfg("b"), device=str(device))
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2], saved[3]
    diff = _state_diff(ts_c, ts_a)
    total = 2 * GROUP_CLI_STEPS_PER_EPOCH
    res = {"uninterrupted": {k: a[k] for k in ("step", "checkpoints", "grouped", "replica_checks", "world")},
           "preempted": {k: b[k] for k in ("step", "checkpoints", "preempted")},
           "resumed": {k: c[k] for k in ("resumed_from", "step", "checkpoints", "replica_checks")},
           "diff": diff, "seconds": a_s}
    log(f"grouped (e): cli/train.py, K={GROUP_K} ({a['grouped']['mode']}), replica check every {GROUP_K} steps "
        f"(NCCL world of {a['world']}), {total} steps at batch {GROUP_BATCH}: checks {a['replica_checks']}; killed "
        f"at step {b['step']} (checkpoints {b['checkpoints']}), resumed from {c['resumed_from']} to {c['step']}: "
        f"final state max |diff| {diff:.3e} against the uninterrupted run ({a_s:.1f} s)")
    if (a["grouped"]["mode"] != "cuda graph" or a["step"] != total or c["step"] != total or not b["preempted"]
            or c["resumed_from"] != b["step"] or diff != 0.0
            or any(r["divergence"] != 0.0 for r in a["replica_checks"] + c["replica_checks"])
            or len(a["replica_checks"]) != total // GROUP_K):
        raise AssertionError(f"grouped (e): {res}")
    return res


def phase_data_parallel(device, tmp: str, searched_path: str | None = None, arm: str | None = None) -> dict:
    """Phase 12: (a) torchrun's world of 1 against no group, started first
    and run beside (a)'s run without a group (in this process) and (c) two
    gloo ranks on the card, then in this process's NCCL world of 1 (b)
    ZeRO, (d) the grouped step and (e) the grouped CLI run with the replica
    check and a resume, beside which ``arm`` of the serve bench runs
    (``start_serve_arm``: (e)'s checks are exact); the world is left at the
    end."""
    import torch
    import torch.distributed as dist

    lap = _laps("12")
    torchrun = _dp_torchrun_start(tmp)
    try:
        plain = _dp_plain(tmp)
        torch.cuda.empty_cache()
        lap("(a) the run without a group")
        gloo = phase_dp_gloo(device, tmp)
        lap("(c) two gloo ranks")
    except BaseException:
        _kill_group(torchrun[0])  # its processes end before the raise goes on
        raise
    out = {"torchrun": phase_dp_torchrun(tmp, plain, torchrun), "gloo": gloo}
    torch.cuda.empty_cache()
    lap("(a) the rest of torchrun's run")
    mesh, made = _world_of_one(device)
    try:
        out["zero"] = phase_dp_zero(device, tmp, mesh)
        torch.cuda.empty_cache()
        lap("(b) ZeRO")
        out["grouped"] = phase_grouped(device, tmp, mesh, searched_path)
        torch.cuda.empty_cache()
        lap("(d) the grouped step")
        beside = start_serve_arm(arm) if arm else None
        try:
            out["grouped_cli"] = phase_grouped_cli(device, tmp)
            lap("(e) the grouped CLI")
            if beside is not None:
                out["serve_arm"] = finish_serve_arm(arm, beside, "phase 12 (e)")
                lap(f"the serve bench's --{arm} arm, the rest of it")
        finally:
            if beside is not None:
                _bench_stop(beside)
    finally:
        if made:
            dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# phase 13: the real-data input path
# ---------------------------------------------------------------------------


def _cpu_model() -> str:
    """The host CPU as /proc/cpuinfo and lscpu name it (a virtual machine may
    report no model name, then its vendor, family and model numbers)."""
    fields: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                k, _, v = line.partition(":")
                fields.setdefault(k.strip(), v.strip())
    except OSError:
        pass
    return (f"{fields.get('model name', '?')} (vendor {fields.get('vendor_id', '?')}, family "
            f"{fields.get('cpu family', '?')}, model {fields.get('model', '?')})")


def phase_real_build(prebuilt=None) -> dict:
    """(a) The host library built with g++ from csrc/ (ops/host_build.py;
    ``prebuilt``: its build started with the run's others, ``start_builds``)
    and loaded: its time, g++'s version, the JPEG library, the CPU and its
    cores; then the library's decodes held to the committed libjpeg decodes
    of tests/fixtures/torch_jpeg (NVJPEG_TOL through nvJPEG, exact through
    libjpeg)."""
    import numpy as np

    from yet_another_mobilenet_series_tpu_torch.data import jpeg, jpeg_corpus
    from yet_another_mobilenet_series_tpu_torch.ops import host_build

    t0 = time.perf_counter()
    built = prebuilt.result()[1] if prebuilt is not None else None
    host_build.load()
    seconds = time.perf_counter() - t0
    if built is not None:  # the compile ran beside the first phases: its own record
        host_build.BUILD_INFO.update(built)
    gxx = subprocess.run([host_build.find_cxx(), "--version"], capture_output=True, text=True, check=True,
                         timeout=60).stdout.splitlines()[0]
    codec = host_build.codec()
    res = {"seconds": seconds, "compile_s": host_build.BUILD_INFO.get("seconds"),
           "cached": host_build.BUILD_INFO.get("cached"), "gxx": gxx, "codec": jpeg.codec(),
           "libjpeg": "installed" if codec == "libjpeg" else "not installed (no jpeglib.h)",
           "cpu": _cpu_model(), "cpu_count": os.cpu_count(), "command": host_build.BUILD_INFO.get("command")}
    log(f"real (a): host library {'built beside phases 1-3' if built else 'built'} (g++ {res['compile_s']} s), "
        f"{'waited for and loaded' if built else 'and loaded'} in {seconds:.2f} s, with {gxx}; libjpeg "
        f"{res['libjpeg']}; JPEG library {res['codec']}; CPU {res['cpu']}, os.cpu_count() {res['cpu_count']}")
    fixtures = os.path.join(REPO, "tests", "fixtures", "torch_jpeg")
    refs = {}
    for name, _, _, sub, target in jpeg_corpus.REFERENCE:
        with open(os.path.join(fixtures, f"{name}.jpg"), "rb") as f:
            data = f.read()
        for kind, tgt, npy in ((sub, 0, f"{name}.npy"), ("reduced", target, f"{name}_t{target}.npy")):
            if kind == "reduced" and not target:
                continue
            want = np.load(os.path.join(fixtures, npy)).astype(np.int32)
            got = jpeg.decode(data, tgt).astype(np.int32)
            if got.shape != want.shape:
                raise AssertionError(f"{npy}: decoded {got.shape}, libjpeg {want.shape}")
            d = np.abs(got - want)
            bar = NVJPEG_TOL[kind] if codec == "nvjpeg" else (0, 0.0)
            refs[npy] = {"max": int(d.max()), "mean": float(d.mean()), "bar": bar}
            if d.max() > bar[0] or d.mean() > bar[1]:
                raise AssertionError(f"{npy}: {res['codec']} against libjpeg max {d.max()}, mean {d.mean():.3f} "
                                     f"(bar {bar})")
    res["reference"] = refs
    log("real (a): decodes against libjpeg's (tests/fixtures/torch_jpeg, max / mean pixel levels): "
        + ", ".join(f"{k} {v['max']}/{v['mean']:.2f}" for k, v in refs.items()))
    return res


def phase_real_write(root: str) -> dict:
    """(b) The datasets, written by the port's encoder at REAL_QUALITY: an
    image folder of REAL_CLASSES classes (train and val), each image a class
    template plus seeded noise at one of jpeg_corpus.SIZES; the val images
    also as REAL_VAL_SHARDS TFRecord shards and the train images as
    REAL_TRAIN_SHARDS, by the port's writer."""
    from yet_another_mobilenet_series_tpu_torch.data import jpeg_corpus

    t0 = time.perf_counter()
    train = jpeg_corpus.write_image_folder(root, "train", REAL_CLASSES, REAL_TRAIN_PER_CLASS, quality=REAL_QUALITY)
    val = jpeg_corpus.write_image_folder(root, "val", REAL_CLASSES, REAL_VAL_PER_CLASS, quality=REAL_QUALITY)
    t_folder = time.perf_counter() - t0
    shards = (jpeg_corpus.write_tfrecords(root, "val", val, REAL_VAL_SHARDS)
              + jpeg_corpus.write_tfrecords(root, "train", train, REAL_TRAIN_SHARDS))
    sizes = [os.path.getsize(p) for p, _ in train + val]
    res = {"train_images": len(train), "val_images": len(val), "mean_jpeg_bytes": sum(sizes) / len(sizes),
           "folder_s": t_folder, "shards_s": time.perf_counter() - t0 - t_folder,
           "shard_bytes": sum(os.path.getsize(p) for p in shards)}
    log(f"real (b): {len(train)} train + {len(val)} val JPEGs (quality {REAL_QUALITY}, mean "
        f"{res['mean_jpeg_bytes'] / 1e3:.1f} kB) in {t_folder:.1f} s; {len(shards)} TFRecord shards "
        f"({res['shard_bytes'] / 1e6:.1f} MB) in {res['shards_s']:.1f} s")
    return res


def _loader_rate(paths, labels, cfg, batches: int) -> float:
    """Train images/s of a native loader over ``batches`` batches, after a
    first one."""
    from yet_another_mobilenet_series_tpu_torch.data import native_loader

    loader = native_loader.NativeLoader(paths, labels, cfg, REAL_BATCH, train=True, seed=0)
    try:
        loader.next_batch()
        t0 = time.perf_counter()
        for _ in range(batches):
            loader.next_batch()
        return batches * REAL_BATCH / (time.perf_counter() - t0)
    finally:
        loader.close()


def _busy_card(device, stop: threading.Event, replays: list) -> None:
    """Keeps the card busy with little host work until ``stop``: a CUDA graph
    of BUSY_MATMULS bf16 matmuls of BUSY_DIM, replayed and waited for on a
    stream of its own."""
    import torch

    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        a = torch.randn(BUSY_DIM, BUSY_DIM, device=device, dtype=torch.bfloat16)
        b = a @ a
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            for _ in range(BUSY_MATMULS):
                b = a @ a
        while not stop.is_set():
            graph.replay()
            stream.synchronize()
            replays.append(time.perf_counter())
    del b


def phase_real_loader(device, root: str) -> dict:
    """(c) The loader alone: train images/s of the native loader (batch
    REAL_BATCH, the run's transform) at one decode thread and at one a core,
    in float32 and uint8, and of the TFRecord train stream at one a core in
    uint8; then the folder at one a core in uint8 beside a busy card
    (``_busy_card``: the card full, the host nearly idle), which tells the
    card's share of what slows the loader beside a training step from the
    host's."""
    import itertools

    import numpy as np

    from yet_another_mobilenet_series_tpu_torch.config import DataConfig
    from yet_another_mobilenet_series_tpu_torch.data import native_loader, pipeline
    from yet_another_mobilenet_series_tpu_torch.obs.registry import get_registry

    paths, labels, _ = native_loader.list_image_folder(os.path.join(root, "train"))
    rows = []
    for uint8 in (True, False):
        for threads in (1, os.cpu_count()):
            cfg = DataConfig(dataset="folder", loader="native", data_dir=root, image_size=IMAGE_SIZE,
                             transfer_uint8=uint8, decode_threads=threads)
            rate = _loader_rate(paths, labels, cfg, 1 if threads == 1 else REAL_LOADER_BATCHES)
            rows.append({"source": "folder", "uint8": uint8, "threads": threads, "images_per_s": rate})
    # the TFRecord train stream with its interleave and record buffer (the
    # default) and with data.deterministic_input (the shards back to back):
    # REAL_LOADER_BATCHES + 1 batches are the first epoch
    for deterministic in (False, True):
        cfg = DataConfig(dataset="imagenet", loader="tfdata", data_dir=root, image_size=IMAGE_SIZE,
                         transfer_uint8=True, decode_threads=os.cpu_count(), prefetch=1,
                         deterministic_input=deterministic)
        stream = pipeline.RecordTrainStream(cfg, REAL_BATCH, 0)
        try:
            batch_labels = [next(stream)["label"]]
            t0 = time.perf_counter()
            batch_labels += [b["label"] for b in itertools.islice(stream, REAL_LOADER_BATCHES)]
            dt = time.perf_counter() - t0
        finally:
            stream.close()
        rows.append({"source": "tfrecords", "uint8": True, "threads": os.cpu_count(),
                     "images_per_s": REAL_LOADER_BATCHES * REAL_BATCH / dt, "deterministic_input": deterministic,
                     "cycle": stream.cycle, "buffer": stream.buffer,
                     "order_s": get_registry().snapshot()["data.epoch_order_seconds"],
                     "distinct_labels_per_batch": float(np.mean([len(np.unique(x)) for x in batch_labels]))})
    # the index simulation at ImageNet's scale: one host's epoch of the train
    # split (1024 shards) at the config's defaults
    defaults = DataConfig()
    lengths = np.full(ORDER_SHARDS, defaults.num_train_examples // ORDER_SHARDS, np.int64)
    lengths[:defaults.num_train_examples % ORDER_SHARDS] += 1
    order_s = []
    for epoch in range(ORDER_EPOCHS):
        t0 = time.perf_counter()
        _, records = pipeline.epoch_records(lengths, 0, epoch, defaults.decode_threads, defaults.shuffle_buffer)
        order_s.append(time.perf_counter() - t0)
        if len(records) != defaults.num_train_examples or len(np.unique(records)) != len(records):
            raise AssertionError(f"epoch {epoch}'s record order at ImageNet's scale is not a permutation")
    order = {"records": defaults.num_train_examples, "shards": ORDER_SHARDS, "cycle": defaults.decode_threads,
             "buffer": defaults.shuffle_buffer, "seconds": order_s}
    busy = None
    if device.type == "cuda":
        stop, replays = threading.Event(), []
        worker = threading.Thread(target=_busy_card, args=(device, stop, replays), daemon=True)
        worker.start()
        try:
            while not replays and worker.is_alive():
                time.sleep(0.01)
            cfg = DataConfig(dataset="folder", loader="native", data_dir=root, image_size=IMAGE_SIZE,
                             transfer_uint8=True, decode_threads=os.cpu_count())
            n0, t0 = len(replays), time.perf_counter()
            rate = _loader_rate(paths, labels, cfg, REAL_LOADER_BATCHES)
            busy = {"images_per_s": rate, "replay_ms": (time.perf_counter() - t0) / max(len(replays) - n0, 1) * 1e3}
        finally:
            stop.set()
            worker.join(timeout=60)
        if worker.is_alive() or not replays:
            raise AssertionError("the busy-card thread did not run or did not stop")
    log(f"real (c): train images/s of the loader alone (batch {REAL_BATCH}, random-resized crop + flip at "
        f"{IMAGE_SIZE}): "
        + "; ".join(f"{r['source']} {'uint8' if r['uint8'] else 'f32'} {r['threads']} thread(s) "
                    + ("" if "cycle" not in r else f"(interleave {r['cycle']}, buffer {r['buffer']}) ")
                    + f"{r['images_per_s']:.0f}" for r in rows)
        + ("" if busy is None else f"; folder uint8 {os.cpu_count()} threads beside a busy card (a graph of "
           f"{BUSY_MATMULS} bf16 {BUSY_DIM}^2 matmuls, {busy['replay_ms']:.1f} ms a replay) "
           f"{busy['images_per_s']:.0f}"))
    log("real (c): the TFRecord stream's first epoch (" + str((REAL_LOADER_BATCHES + 1) * REAL_BATCH) + " records, "
        f"{REAL_CLASSES} classes, shards of the port's writer): mean distinct labels a batch of {REAL_BATCH} "
        + ", ".join(f"{r['distinct_labels_per_batch']:.2f} ("
                    + ("deterministic_input" if r["deterministic_input"] else "buffered")
                    + f", the last epoch's order in {r['order_s']:.4f} s)" for r in rows if "cycle" in r)
        + f"; the index simulation of one host's ImageNet epoch ({order['records']} records, {ORDER_SHARDS} shards, "
        f"interleave {order['cycle']}, buffer {order['buffer']}): " + ", ".join(f"{t:.3f}" for t in order_s)
        + f" s (bar {ORDER_SECONDS_BAR} s)")
    if max(order_s) > ORDER_SECONDS_BAR:
        raise AssertionError(f"the record order of an ImageNet epoch took {max(order_s):.3f} s, over "
                             f"{ORDER_SECONDS_BAR} s")
    return {"rows": rows, "busy_card": busy, "order": order}


def _real_cfg(tmp: str, tag: str, root: str, *extra: str):
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    return parse_cli([f"app:{REAL_APP}", f"data.data_dir={root}", "data.val_split=val",
                      f"data.num_train_examples={REAL_CLASSES * REAL_TRAIN_PER_CLASS}",
                      f"data.num_eval_examples={REAL_VAL_IMAGES}", f"data.decode_threads={os.cpu_count()}",
                      f"train.batch_size={REAL_BATCH}", f"train.eval_batch_size={REAL_BATCH}",
                      f"train.epochs={REAL_STEPS / REAL_STEPS_PER_EPOCH}", f"train.log_every={REAL_LOG_EVERY}",
                      "train.eval_every_epochs=100", "train.checkpoint_every_epochs=100", "dist.num_devices=1",
                      f"train.log_dir={os.path.join(tmp, 'log_real_' + tag)}", *extra])


def _window_ms(summary: dict) -> dict:
    """ms per step of each log window, by its last step: from the window's
    images/s, which a log point measures between two reads of the device."""
    return {row["step"]: REAL_BATCH / row["images_per_sec"] * 1e3 for row in summary["log"]}


def _steady_ms(windows: dict, profiled: bool) -> float:
    """The median ms per step over the windows after the warm-up, without
    the profiler window's (REAL_WARMUP_STEPS)."""
    touched = range(REAL_PROFILE_AFTER + 1, REAL_PROFILE_AFTER + REAL_PROFILE_STEPS + 2) if profiled else ()
    keep = sorted(ms for step, ms in windows.items() if step - REAL_LOG_EVERY >= REAL_WARMUP_STEPS
                  and not any(s in touched for s in range(step - REAL_LOG_EVERY + 1, step + 1)))
    return keep[len(keep) // 2] if len(keep) % 2 else (keep[len(keep) // 2 - 1] + keep[len(keep) // 2]) / 2


def phase_real_train(device, tmp: str, root: str) -> tuple[dict, str]:
    """(d) The run fed by the fake stream (made on the device), then
    cli/train.py's run() from the image folder (prefetch thread, uint8
    transfer, REAL_STEPS steps, a profiler window over steps 8-11); the fake
    run goes first, so the folder run's first steps pay no first use of its
    shapes in cuDNN. Gates: every step finite, eval_n == REAL_VAL_IMAGES, 0
    decode failures, the window's trace written with the card's kernels in
    it. Returns the results and the folder run's checkpoint dir."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.bench import trace_ops
    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise

    runs = {}
    for tag, extra in (("fake", ["data.dataset=fake", "data.loader=tfdata",
                                 f"data.fake_train_size={REAL_CLASSES * REAL_TRAIN_PER_CLASS}",
                                 f"data.fake_eval_size={REAL_VAL_IMAGES}", f"data.fake_num_classes={REAL_CLASSES}"]),
                       ("folder", ["data.dataset=folder", "data.loader=native", "data.prefetch_thread=true",
                                   "data.transfer_uint8=true", f"train.profile_start_step={REAL_PROFILE_AFTER}",
                                   f"train.profile_num_steps={REAL_PROFILE_STEPS}"])):
        cfg = _real_cfg(tmp, tag, root, *extra)
        torch.cuda.synchronize()
        fused_depthwise.launches = 0
        t0 = time.perf_counter()
        summary = train_cli.run(cfg, device=str(device))
        windows = _window_ms(summary)
        runs[tag] = {"summary": summary, "wall_s": time.perf_counter() - t0, "k1_launches": fused_depthwise.launches,
                     "windows_ms": windows, "ms_per_step": _steady_ms(windows, tag == "folder"),
                     "log_dir": cfg.train.log_dir}
    folder, fake = runs["folder"], runs["fake"]
    s = folder["summary"]
    if not (s["steps"] == s["finite_steps"] == REAL_STEPS and s["device"].startswith("cuda")
            and s["eval_n"] == REAL_VAL_IMAGES and s["decode_failures"] == 0 and s["profile"] is not None):
        raise AssertionError(f"the run from the image folder: {s}")
    if not (fake["summary"]["finite_steps"] == REAL_STEPS and fake["summary"]["eval_n"] == REAL_VAL_IMAGES):
        raise AssertionError(f"the run from the fake stream: {fake['summary']}")
    doc, path = trace_ops.load_trace(s["profile"]["path"])
    agg = trace_ops.aggregate(doc)
    if not agg["device"]:
        raise AssertionError(f"the profiler window's trace {path} holds no kernel of the card")
    window = {"path": path, "bytes": os.path.getsize(path), "busy_share": agg["busy_share"],
              "window_ms": agg["window_us"] / 1e3, "busy_ms": agg["busy_us"] / 1e3,
              "ms_per_step": agg["window_us"] / 1e3 / REAL_PROFILE_STEPS,
              "top": [(name[:80], us / 1e3) for name, us in agg["per_name"].most_common(5)]}
    paced = folder["ms_per_step"] > HOST_PACED_FACTOR * fake["ms_per_step"]
    res = {"folder": folder, "fake": fake, "window": window, "host_paced": paced,
           "needed_images_per_s": REAL_BATCH / fake["ms_per_step"] * 1e3}
    log(f"real (d): cli.train.run from the folder (MobileNetV2 1.0 at {IMAGE_SIZE}, bf16, batch {REAL_BATCH}, "
        f"{cfg.data.decode_threads} decode threads, prefetch thread, uint8 transfer): {s['steps']} finite steps, "
        f"eval_n {s['eval_n']} top-1 {s['eval_top1']:.4f} loss {s['eval_loss']:.5f}, decode failures "
        f"{s['decode_failures']}, {folder['wall_s']:.1f} s; ms per step (the median of 2-step windows after step "
        f"{REAL_WARMUP_STEPS}, outside the profiler's) fed by the loader {folder['ms_per_step']:.1f}, fed by the fake "
        f"stream {fake['ms_per_step']:.1f}; each window (by its last step) from the folder "
        + ", ".join(f"{k} {v:.0f}" for k, v in folder["windows_ms"].items()) + ", fake "
        + ", ".join(f"{k} {v:.0f}" for k, v in fake["windows_ms"].items()) + f"; profiler window (steps "
        f"{s['profile']['first_step']}-{s['profile']['last_step']}): {window['ms_per_step']:.1f} ms a step, device "
        f"busy {100 * window['busy_share']:.1f}%; the host {'PACES' if paced else 'does not pace'} the step "
        f"(the step takes {res['needed_images_per_s']:.0f} images/s); trace {window['bytes'] / 1e6:.1f} MB")
    return res, os.path.join(folder["log_dir"], "ckpt")


def phase_real_records_eval(device, tmp: str, root: str, ckpt_dir: str, folder_summary: dict) -> dict:
    """(e) The same eval from the TFRecord shards (imagenet/tfdata, the
    port's reader), an eval-only run of (d)'s checkpoint: eval_n ==
    REAL_VAL_IMAGES, and top-1 and loss equal to (d)'s folder eval (the same
    pixels, decoded by the same code, in the same batches, and the same
    weights)."""
    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli

    cfg = _real_cfg(tmp, "records", root, "data.dataset=imagenet", "data.loader=tfdata", "data.transfer_uint8=true",
                    "train.test_only=true", f"train.pretrained={ckpt_dir}")
    t0 = time.perf_counter()
    summary = train_cli.run(cfg, device=str(device))
    res = {"summary": summary, "wall_s": time.perf_counter() - t0,
           "loss_diff": abs(summary["eval_loss"] - folder_summary["eval_loss"])}
    log(f"real (e): eval-only from {REAL_VAL_SHARDS} TFRecord shards of step {summary['step']}: eval_n "
        f"{summary['eval_n']}, top-1 {summary['eval_top1']:.4f} (folder {folder_summary['eval_top1']:.4f}), loss "
        f"{summary['eval_loss']:.7f} (folder {folder_summary['eval_loss']:.7f}, |diff| {res['loss_diff']:.2e}), "
        f"{res['wall_s']:.1f} s")
    if (summary["eval_n"] != REAL_VAL_IMAGES or summary["eval_top1"] != folder_summary["eval_top1"]
            or summary["eval_loss"] != folder_summary["eval_loss"]):
        raise AssertionError(f"the TFRecord eval differs from the folder's: {summary} vs {folder_summary}")
    return res


def phase_real_resume(root: str) -> dict:
    """(f) Each loader stream restarted at each step of REAL_RESUME_AT gives
    the uninterrupted stream's batches from there on bit for bit, from the
    folder and from the TFRecord shards (uint8, batch REAL_RESUME_BATCH; the
    TFRecord stream with its default interleave and record buffer): mid-epoch,
    and across the boundary into the second epoch."""
    import itertools

    import torch

    from yet_another_mobilenet_series_tpu_torch.config import DataConfig
    from yet_another_mobilenet_series_tpu_torch.data import make_train_source

    res = {}
    for tag, kw in (("folder", {"dataset": "folder", "loader": "native"}),
                    ("tfrecords", {"dataset": "imagenet", "loader": "tfdata"})):
        cfg = DataConfig(**kw, data_dir=root, image_size=IMAGE_SIZE, transfer_uint8=True, decode_threads=os.cpu_count())
        t0 = time.perf_counter()
        full = list(itertools.islice(make_train_source(cfg, REAL_RESUME_BATCH, 0, device="cpu"), REAL_RESUME_STEPS))
        res[tag] = {"seconds": 0.0}
        for at in REAL_RESUME_AT:
            resumed = list(itertools.islice(make_train_source(cfg, REAL_RESUME_BATCH, 0, start_step=at, device="cpu"),
                                            REAL_RESUME_STEPS - at))
            same = [torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
                    for a, b in zip(full[at:], resumed)]
            res[tag][at] = all(same) and len(same) == REAL_RESUME_STEPS - at
        res[tag]["equal"] = all(res[tag][at] for at in REAL_RESUME_AT)
        res[tag]["seconds"] = time.perf_counter() - t0
    log(f"real (f): streams restarted at steps {REAL_RESUME_AT} (batch {REAL_RESUME_BATCH}, uint8, "
        f"{REAL_CLASSES * REAL_TRAIN_PER_CLASS // REAL_RESUME_BATCH} batches an epoch), each against the "
        f"uninterrupted stream to batch {REAL_RESUME_STEPS - 1}: " + ", ".join(
            f"{tag} " + " / ".join(f"{at} {'equal' if r[at] else 'DIFFERENT'}" for at in REAL_RESUME_AT)
            + f" ({r['seconds']:.1f} s)" for tag, r in res.items()))
    if not all(r["equal"] for r in res.values()):
        raise AssertionError(f"a resumed loader stream differs from the uninterrupted one: {res}")
    return res


def phase_real_serve(device, tmp: str, root: str, ckpt_dir: str) -> dict:
    """(g) (d)'s checkpoint exported by cli/serve.py's serve.export_from and
    served on the uint8 wire: run() (buckets 1/8/32, f32), then an engine
    built as cli/serve.py builds it serving the REAL_VAL_IMAGES val centre
    crops (uint8) in its graphs, the counts at 0 before each and read after;
    logits within FOLD_ATOL of the CPU folded forward of the same bundle, K1
    LIFE_PER_FORWARD launches a forward in every graph, and the card's own
    count of K1's launches equal to each accounting and to LIFE_PER_FORWARD
    a forward over SERVED_FORWARDS forwards at REAL_SERVE_BUCKET."""
    tf32_off("the served logits against the CPU folded forward at FOLD_ATOL")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.config import DataConfig, parse_cli
    from yet_another_mobilenet_series_tpu_torch.data import make_eval_source
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import load_bundle

    bundle_dir = os.path.join(tmp, "real_bundle")
    cfg = parse_cli([f"app:{APP}", f"serve.export_from={ckpt_dir}", f"serve.bundle={bundle_dir}",
                     f"serve.requests={REAL_SERVE_REQUESTS}", f"serve.clients={SERVE_CLIENTS}",
                     "serve.compute_dtype=float32", "serve.quant.wire=uint8", f"data.image_size={IMAGE_SIZE}",
                     f"train.log_dir={os.path.join(tmp, 'log_real_serve')}"])
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    card0 = _k1_on_card()
    result = serve_cli.run(cfg, device=str(device))
    run_k1 = _k1_accounting(result["graphs"], fused_depthwise.launches, LIFE_PER_FORWARD)
    run_k1["card"] = _k1_card_gate(card0, run_k1["launches"], "cli.serve.run on the uint8 wire")
    if (result["completed"] != REAL_SERVE_REQUESTS or result["shed"] or result["rejected_full"]
            or result["dispatches"] != result["replays"] or result["bundle"] != bundle_dir):
        raise AssertionError(f"serve.export_from on the uint8 wire: {result}")
    crops = [b for b in make_eval_source(DataConfig(dataset="folder", loader="native", data_dir=root,
                                                    val_split="val", image_size=IMAGE_SIZE, transfer_uint8=True,
                                                    decode_threads=os.cpu_count()), REAL_BATCH, device="cpu")]
    images = torch.cat([b["image"][b["label"] >= 0] for b in crops]).numpy()
    if images.shape != (REAL_VAL_IMAGES, IMAGE_SIZE, IMAGE_SIZE, 3) or images.dtype != np.uint8:
        raise AssertionError(f"the val centre crops: {images.shape} {images.dtype}")
    bundle = load_bundle(bundle_dir)
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    card0 = _k1_on_card()
    engine = InferenceEngine(bundle, device=str(device), **serve_cli.engine_kwargs(cfg))
    engine.warmup()
    t0 = time.perf_counter()
    got = engine.predict(images)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    k1 = _k1_accounting(engine.graph_report(), fused_depthwise.launches, LIFE_PER_FORWARD)
    k1["card"] = _k1_card_gate(card0, k1["launches"], f"the {REAL_VAL_IMAGES} val crops through the engine")
    # K1 a forward on the card's own counter, SERVED_FORWARDS forwards of one bucket
    card0 = _k1_on_card()
    for _ in range(SERVED_FORWARDS):
        engine.predict(images[:REAL_SERVE_BUCKET])
    counted = _k1_card_gate(card0, LIFE_PER_FORWARD * SERVED_FORWARDS,
                            f"{SERVED_FORWARDS} forwards of {REAL_SERVE_BUCKET} val crops on the uint8 wire")
    cpu = InferenceEngine(load_bundle(bundle_dir), device="cpu", buckets=(REAL_SERVE_BUCKET,), image_size=IMAGE_SIZE,
                          wire="uint8", wire_mean=cfg.data.mean, wire_std=cfg.data.std)
    want = cpu.predict(images)
    err = float(np.abs(got - want).max())
    res = {"run": {k: result[k] for k in ("completed", "qps", "p50_ms", "p99_ms", "dispatches", "replays")},
           "run_k1": run_k1, "k1": k1, "launches": run_k1["launches"] + k1["launches"], "max_abs_err": err,
           "max_logit": float(np.abs(want).max()), "predict_s": predict_s,
           "card_per_forward": counted / SERVED_FORWARDS,
           "top1_vs_labels": float((got.argmax(-1) == torch.cat([b["label"][b["label"] >= 0] for b in crops])
                                    .numpy()).mean())}
    log(f"real (g): step {bundle.meta['step']} exported and served on the uint8 wire: cli.serve.run "
        f"{result['completed']} requests, {result['qps']:.1f} QPS, {result['dispatches']} dispatches = "
        f"{result['replays']} replays; the {REAL_VAL_IMAGES} val crops through the engine's graphs in "
        f"{predict_s * 1e3:.1f} ms, {k1['replayed']} K1 launches replayed ({run_k1['card']} and {k1['card']} on the "
        f"card's own counter); logits vs the CPU folded forward max |err| {err:.3e} (atol {FOLD_ATOL}), max |logit| "
        f"{res['max_logit']:.3e}; K1 {counted} launches in {SERVED_FORWARDS} forwards of {REAL_SERVE_BUCKET} crops on "
        f"the card's own counter")
    if got.shape != want.shape or not np.isfinite(got).all() or err > FOLD_ATOL:
        raise AssertionError(f"the served val crops' logits differ from the CPU folded forward by {err:.3e}")
    return res


def phase_real_data(device, tmp: str, prebuilt=None) -> dict:
    """Phase 13: (a) build (``prebuilt``: started with the run's others), (b)
    datasets, (c) the loader alone, (d) training from the folder and from
    the fake stream, (e) the TFRecord eval, (f) resume, (g) export and
    serve."""
    import torch

    t0 = time.perf_counter()
    lap = _laps("13")
    root = os.path.join(tmp, "jpegs")
    res = {"build": phase_real_build(prebuilt)}
    lap("(a) the host library")
    res["data"] = phase_real_write(root)
    lap("(b) the datasets")
    res["loader"] = phase_real_loader(device, root)
    lap("(c) the loader alone")
    res["train"], ckpt_dir = phase_real_train(device, tmp, root)
    lap("(d) two training runs")
    res["records_eval"] = phase_real_records_eval(device, tmp, root, ckpt_dir, res["train"]["folder"]["summary"])
    res["resume"] = phase_real_resume(root)
    torch.cuda.empty_cache()
    lap("(e)-(f) the TFRecord eval and the restarts")
    res["serve"] = phase_real_serve(device, tmp, root, ckpt_dir)
    lap("(g) export and serve")
    res["seconds"] = time.perf_counter() - t0
    log(f"real: phase 13 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 14: the training-side tools
# ---------------------------------------------------------------------------

# (a) the BN-mode A/B at full width, a subset of bn_bench's variants that
# keeps every family (exact, folded, compute, fused_vjp, remat, the 1x1
# matmuls), fewer iterations than its 20
TOOLS_VARIANTS = "exact:0,folded:0,compute:0,fused_vjp:0,exact:save_conv,exact:0:dot"
TOOLS_BN_BATCH = 256  # bn_bench's default
TOOLS_BN_ITERS = 6
# (c) the tuned run: apps/mobilenet_v3_large.yml at 224, cut to a batch of
# 64 and 8 steps (two groups of the grouped step when the tuning adopts it)
TOOLS_TUNED_BATCH = 64
TOOLS_TUNED_STEPS = 8
TOOLS_INPUT_BATCHES = 8
TOOLS_TIMEOUT_S = 600
TOOLS_CHAOS_FINAL_STEP = 32  # the chaos config's 2 epochs of 16 steps


def phase_tools_ab(tmp: str) -> dict:
    """(a) bench/bn_bench.py on MobileNetV3-Large 1.0 at 224, bf16, with the
    dispatch probe: every variant timed with a finite loss, the probe a CUDA
    graph; (b) bench/tuning_decide.py on its artifact into a temporary
    tuning file, which train/tuning.py must accept."""
    from yet_another_mobilenet_series_tpu_torch.bench import tuning_decide
    from yet_another_mobilenet_series_tpu_torch.train import tuning

    ab_path = os.path.join(tmp, "bn_ab.json")
    ab = _bench_here("bn_bench", "--variants", TOOLS_VARIANTS, "--batch", str(TOOLS_BN_BATCH), "--iters",
                     str(TOOLS_BN_ITERS), "--dispatch-probe", "--out", ab_path)
    rows, planned = ab["rows"], len(TOOLS_VARIANTS.split(",")) + 1
    probe = rows[-1]
    if (ab["partial"] or len(rows) != planned or ab["batch"] != TOOLS_BN_BATCH or ab["image_size"] != IMAGE_SIZE
            or not all(r["ms_per_step"] > 0 and r["ms_per_step"] == r["ms_per_step"] for r in rows)
            or not all(abs(r["loss"]) < 1e3 for r in rows) or probe["mode"] != "cuda graph"
            or not isinstance(probe["dispatch_tax_ms"], float)):
        raise AssertionError(f"bn_bench: {json.dumps(ab)[:3000]}")
    log(f"tools (a): bn_bench on MobileNetV3-Large 1.0 at {IMAGE_SIZE}, bf16, batch {TOOLS_BN_BATCH}, "
        f"{TOOLS_BN_ITERS} steps a variant ({ab['_seconds']:.1f} s): "
        + "; ".join(f"{r['bn_mode']}:{r['remat']}{':dot' if r['conv1x1_dot'] else ''} {r['ms_per_step']:.2f} ms "
                    f"({r.get('vs_exact', 0):.3f}x exact, loss {r['loss']:.4f})" for r in rows[:-1])
        + f"; dispatch probe: eager {probe['ms_per_step_chained']:.2f} ms a step, {tuning_decide.DISPATCH_K} steps as "
        f"one CUDA graph {probe['ms_per_step']:.2f}, tax {probe['dispatch_tax_ms']:.2f} ms")
    tuning_path = os.path.join(tmp, "BENCH_TUNING_TORCH.json")
    decision = tuning_decide.decide(ab_path, os.path.join(tmp, "decision.json"), tuning_path)
    if not os.path.exists(tuning_path):
        # nothing adopted: a file with no tuning keys runs the baseline
        with open(tuning_path, "w") as f:
            json.dump({"source": f"{os.path.basename(ab_path)}: no variant and no dispatch tax past the rules"}, f)
    with open(tuning_path) as f:
        raw = json.load(f)
    tuned = tuning.validate_tuning(raw)
    log(f"tools (b): tuning_decide: winner {decision['winner'] and decision['winner']['bn_mode']} "
        f"(adopted {decision['adopted']}), dispatch adopted {decision.get('dispatch_adopted')}; tuning file {raw}")
    return {"ab": ab, "decision": decision, "tuning": raw, "tuned": tuned, "tuning_path": tuning_path}


def phase_tools_tuned_run(tmp: str, tuning_path: str) -> dict:
    """(c) cli/train.py's ``main`` (as ``python -m ...cli.train`` runs it)
    with train.tuning_file: its provenance lines logged, the step config
    that ran the tuned one (the "train step:" line against the YAML with the
    file applied here), the grouped step a CUDA graph when the file sets
    steps_per_dispatch > 1, every step finite, and no K1 launch (the
    wrapper's count, 0 just before)."""
    import contextlib
    import io

    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.train import tuning

    log_dir = os.path.join(tmp, "tools_tuned")
    args = [f"app:{TRAIN_APP}", "data.dataset=fake", f"data.image_size={IMAGE_SIZE}",
            f"train.batch_size={TOOLS_TUNED_BATCH}", f"data.fake_train_size={TOOLS_TUNED_BATCH * TOOLS_TUNED_STEPS}",
            f"data.fake_eval_size={TOOLS_TUNED_BATCH * 2}", f"train.eval_batch_size={TOOLS_TUNED_BATCH}",
            "train.epochs=1", "train.log_every=4", "dist.num_devices=1", f"train.log_dir={log_dir}",
            f"train.tuning_file={tuning_path}"]
    cfg, lines = tuning.apply_tuning_file(parse_cli(args))
    t = cfg.train
    want = (f"train step: bn_mode={t.bn_mode} remat={t.remat} remat_policy={t.remat_policy} "
            f"conv1x1_dot={t.conv1x1_dot} steps_per_dispatch={t.steps_per_dispatch}")
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            summary = train_cli.main([*args, "--device", "cuda"])
    except Exception as e:
        raise AssertionError(f"the tuned cli.train run raised {type(e).__name__}: {e}; {buf.getvalue()[-3000:]}")
    seconds = time.perf_counter() - t0
    k1 = fused_depthwise.launches
    out = buf.getvalue()
    first = summary["log"][0]
    grouped = t.steps_per_dispatch > 1
    if (not all(line in out for line in lines) or want not in out or summary["finite_steps"] != TOOLS_TUNED_STEPS
            or summary["steps"] != TOOLS_TUNED_STEPS or not summary["device"].startswith("cuda") or k1 != 0
            or (grouped and (first.get("grouped_k") != t.steps_per_dispatch or first.get("grouped_graph") != 1.0))):
        raise AssertionError(f"the tuned cli.train run (want {lines} and {want!r}, K1 {k1}): {out[-3000:]}")
    log(f"tools (c): cli.train with train.tuning_file (MobileNetV3-Large 1.0 at {IMAGE_SIZE}, batch "
        f"{TOOLS_TUNED_BATCH}, {TOOLS_TUNED_STEPS} steps, {seconds:.1f} s): logged {lines}; ran {want!r}"
        + (f", the grouped step a CUDA graph of {t.steps_per_dispatch}" if grouped else ""))
    return {"lines": lines, "step_config": want, "seconds": seconds, "first_log_row": first, "k1_launches": k1}


def phase_tools_input(root: str) -> dict:
    """(d) bench/input_bench.py on phase 13's corpus: the image folder and
    the TFRecord shards, uint8 on the wire, a decode thread a core."""
    res = {}
    for pipeline in ("native", "tfrecord"):
        out = _bench_here("input_bench", "--pipeline", pipeline, "--data-dir", root, "--batch", str(REAL_BATCH),
                          "--batches", str(TOOLS_INPUT_BATCHES), "--transfer-uint8")
        if not out["images_per_sec"] > 0:
            raise AssertionError(f"input_bench {pipeline}: {out}")
        res[pipeline] = out
    log(f"tools (d): input_bench on phase 13's corpus (batch {REAL_BATCH}, {TOOLS_INPUT_BATCHES} batches, uint8, "
        f"{os.cpu_count()} threads, {res['native']['codec']}): "
        + ", ".join(f"{k} {v['images_per_sec']:.0f} images/s" for k, v in res.items()))
    return res


def phase_tools_chaos(started) -> dict:
    """(e) bench/train_chaos.py on the card (``started``: its process,
    begun beside (c)): the chaos round's corrupt records skipped and
    counted, the NaN step rolled back, the SIGTERM checkpointed with its
    marker; the resume from the marker's step to the end."""
    out = _bench_finish("train_chaos", started, TOOLS_TIMEOUT_S)
    c, r = out["chaos"], out["resume"]
    if not (out["value"] and out["value"] > 0 and c["injected_nan_steps"] == 1 == c["skipped_steps"]
            and c["corrupt_records"] == c["injected_corrupt"] > 0 and c["preemptions"] == 1
            and c["reason"] == "SIGTERM" and r["marker_consumed"] and r["resumed_step"] == c["killed_step"] > 0
            and r["final_step"] == TOOLS_CHAOS_FINAL_STEP and not c["health_abort"]):
        raise AssertionError(f"train_chaos: {json.dumps(out)[:3000]}")
    log(f"tools (e): train_chaos on the card ({out['_seconds']:.1f} s): {c['injected_corrupt']:.0f} corrupt records "
        f"skipped, {c['skipped_steps']:.0f} NaN step rolled back, SIGTERM at step {c['killed_step']}, resumed at "
        f"{r['resumed_step']} to {r['final_step']}: {out['value']:.0f} steps recovered")
    return out


def phase_tools(device, tmp: str, pool=None, beside=None) -> dict:
    """Phase 14: (a)-(b) the A/B and its decision, (c) the tuned run and
    ``beside`` (phase 17's checks) beside (e) the training chaos round (its
    own processes) and, with ``pool``, phase 15 (d)'s dry run
    (``start_dryrun``): none of them is timed; then (d) the input bench on
    phase 13's corpus, alone."""
    t0 = time.perf_counter()
    lap = _laps("14")
    res = phase_tools_ab(tmp)
    lap("(a)-(b) the BN A/B and its decision")
    if pool is not None:
        res["dryrun_started"] = start_dryrun(pool)
    chaos = _bench_start("train_chaos", "--timeout-s", str(TOOLS_TIMEOUT_S // 2))
    try:
        res["tuned_run"] = phase_tools_tuned_run(tmp, res["tuning_path"])
        if beside is not None:
            res["beside"] = beside()
    except BaseException:
        _bench_wait(chaos, TOOLS_TIMEOUT_S)  # its processes end before the raise goes on
        raise
    res["chaos"] = phase_tools_chaos(chaos)
    if "dryrun_started" in res:  # (d) runs alone: the dry run's rank has ended
        futures_wait([res["dryrun_started"]], timeout=DRYRUN_TIMEOUT_S)
    lap("(c) and (e) the tuned run and phase 17's checks beside the chaos round (and phase 15 (d))")
    res["input"] = phase_tools_input(os.path.join(tmp, "jpegs"))
    lap("(d) the input bench")
    res["seconds"] = time.perf_counter() - t0
    log(f"tools: phase 14 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 15: the serving mesh, the overload arm and the data-parallel dry run
# ---------------------------------------------------------------------------

MESH_BUCKETS = (8, 32)
MESH_ROWS = (32, 20, 8)  # a full bucket 32, a padded one (10 rows a lane over two lanes), a full bucket 8
MESH_TIMED_ITERS = 20
MESH_TIMED_ROUNDS = 3
MESH_SERVE_REQUESTS = 64
# the overload arm's cuts of the bench's defaults (5 s storms, 60 gray
# requests), to keep the phase near 90 s
OVERLOAD_STORM_S = 3.0
OVERLOAD_GRAY_REQUESTS = 40
# the storm's multiple of the calibrated capacity (the bench's default 3).
# The calibration, 32 closed-loop clients of 12 timed requests each, read
# 649.9-713.0 QPS on the card with the bench alone and 493.0 in this script,
# and the paced stack under a storm completes about 1340 QPS of all
# classes. At 4x (1972.1-2809.1 QPS) the storm is 1.5-2.1x that ceiling
# while its interactive share (40%) is below it: the overload the ladder is
# for. Availability off / on read 0.05-0.43 / 0.53-0.83 at 4x, and the
# ladder won at every multiple tried from 3x to 8x (on an NVIDIA H100 80GB
# HBM3 at 700 W)
OVERLOAD_MULTIPLE = 4.0


def phase_mesh_engine(device, bundle_dir: str, per_forward: int) -> dict:
    """(b) the serving mesh at full width, MobileNetV3-Large 1.0 at 224,
    f32, buckets 8/32, the counts at 0 before the engines are built and
    read after their traffic: a mesh of 1 on the card bit for bit against
    the single-device engine, and a mesh of two lanes on the same card (an
    explicit device list: two replicas of one card, not two cards) within
    SLICE_RTOL/SLICE_ATOL of it, at MESH_ROWS rows; then each engine's QPS
    at bucket 32 in MESH_TIMED_ROUNDS interleaved rounds of
    MESH_TIMED_ITERS predicts. K1's launches are each graph's captured
    launches (per_forward a lane) x its replays, the warm runs beside them,
    and the card's own count equals them."""
    tf32_off("the two-lane mesh against the single-device engine at SLICE_RTOL/SLICE_ATOL")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.parallel import make_serving_mesh
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import load_bundle

    bundle = load_bundle(bundle_dir)
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    card0 = _k1_on_card()
    t0 = time.perf_counter()
    engines = {"single": InferenceEngine(bundle, buckets=MESH_BUCKETS, image_size=IMAGE_SIZE, device=str(device)),
               "mesh of 1": InferenceEngine(bundle, buckets=MESH_BUCKETS, image_size=IMAGE_SIZE, device=str(device),
                                            mesh=make_serving_mesh(devices=[device])),
               "mesh of two lanes on one card": InferenceEngine(
                   bundle, buckets=MESH_BUCKETS, image_size=IMAGE_SIZE, device=str(device),
                   mesh=make_serving_mesh(devices=[device, device]))}
    for e in engines.values():
        e.warmup()
    warm_s = time.perf_counter() - t0
    single, one, two = engines.values()
    x = np.random.RandomState(15).normal(0, 1, (max(MESH_ROWS), IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    ref = {n: single.predict(x[:n]) for n in MESH_ROWS}
    bitwise = {n: bool(np.array_equal(one.predict(x[:n]), ref[n])) for n in MESH_ROWS}
    errs, close = {}, {}
    for n in MESH_ROWS:
        got = two.predict(x[:n])
        errs[n] = float(np.abs(got - ref[n]).max())
        close[n] = bool(got.shape == ref[n].shape and np.isfinite(got).all()
                        and np.all(np.abs(got - ref[n]) <= SLICE_ATOL + SLICE_RTOL * np.abs(ref[n])))
    qps: dict = {name: [] for name in engines}
    for _ in range(MESH_TIMED_ROUNDS):
        for name, e in engines.items():
            e.predict(x)
            t1 = time.perf_counter()
            for _ in range(MESH_TIMED_ITERS):
                e.predict(x)
            qps[name].append(max(MESH_ROWS) * MESH_TIMED_ITERS / (time.perf_counter() - t1))
    torch.cuda.synchronize()
    graphs = [g for e in engines.values() for g in e.graph_report()]
    k1 = _k1_accounting(graphs, fused_depthwise.launches, per_forward)
    k1["card"] = _k1_card_gate(card0, k1["launches"], "the mesh check's three engines")
    by_engine = {name: sum(g["warm_k1"] + g["replays"] * g["k1_launches"] for g in e.graph_report())
                 for name, e in engines.items()}
    lanes = {name: sorted({g["lanes"] for g in e.graph_report()}) for name, e in engines.items()}
    two_lane_replay = sorted({g["k1_launches"] for g in two.graph_report()})
    res = {"bitwise_mesh_of_1": bitwise, "max_abs_err_two_lanes": errs, "close_two_lanes": close,
           "rtol": SLICE_RTOL, "atol": SLICE_ATOL, "max_logit": float(np.abs(ref[max(MESH_ROWS)]).max()),
           "qps_bucket32": qps, "qps_bucket32_median": {k: sorted(v)[len(v) // 2] for k, v in qps.items()},
           "warmup_s": warm_s, "k1": k1, "launches": k1["launches"], "launches_by_engine": by_engine, "lanes": lanes,
           "two_lane_launches_per_replay": two_lane_replay,
           "devices": {name: [str(d) for d in e.mesh.devices] if e.mesh else [str(e.device)]
                       for name, e in engines.items()}}
    med = res["qps_bucket32_median"]
    log(f"mesh (b): MobileNetV3-Large 1.0 at {IMAGE_SIZE}, f32, buckets {MESH_BUCKETS}: a mesh of 1 on {device} bit "
        f"for bit against the single-device engine at {MESH_ROWS} rows: {bitwise}; a mesh of two lanes on the one "
        f"card ({res['devices']['mesh of two lanes on one card']}, two replicas of one card, not two cards) max "
        f"|diff| {errs} (rtol {SLICE_RTOL}, atol {SLICE_ATOL}, max |logit| {res['max_logit']:.3e}); QPS at bucket "
        f"32, median of {MESH_TIMED_ROUNDS} interleaved rounds of {MESH_TIMED_ITERS} predicts: "
        + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
        + f"; K1 {k1['launches']} launches ({k1['warm']} warm + {k1['replayed']} replayed; per engine {by_engine}; "
        f"{k1['card']} on the card's own counter); lanes per graph {lanes}; engines built and warmed in {warm_s:.1f} s")
    if not all(bitwise.values()) or not all(close.values()):
        raise AssertionError(f"mesh (b): the mesh engines differ from the single-device engine: {res}")
    if lanes != {"single": [1], "mesh of 1": [1], "mesh of two lanes on one card": [2]} or k1["replayed"] <= 0:
        raise AssertionError(f"mesh (b): the graphs' lanes or K1's launches are off: {res}")
    return res


def phase_mesh_cli(device, tmp: str, bundle_dir: str, per_forward: int) -> dict:
    """(b) cli/serve.py's run() with serve.data_parallel=true on the shipped
    config (dist.num_devices 0: every visible card), MESH_SERVE_REQUESTS
    single-image requests, the counts at 0 before and read after: every
    request completed, the engine's mesh the visible cards, every graph a
    per-chunk key of one lane a card (the fused ladder falls back, the ring
    stays off) and every dispatch a replay of each lane."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import serve as serve_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise

    cfg = parse_cli([f"app:{APP}", f"serve.bundle={bundle_dir}", "serve.data_parallel=true",
                     f"serve.requests={MESH_SERVE_REQUESTS}", f"serve.clients={SERVE_CLIENTS}",
                     "serve.compute_dtype=float32", f"data.image_size={IMAGE_SIZE}",
                     f"train.log_dir={os.path.join(tmp, 'log_mesh_serve')}"])
    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    card0 = _k1_on_card()
    result = serve_cli.run(cfg, device=str(device))
    k1 = _k1_accounting(result["graphs"], fused_depthwise.launches, per_forward)
    k1["card"] = _k1_card_gate(card0, k1["launches"], "cli.serve.run with serve.data_parallel")
    cards = [str(torch.device("cuda", i)) for i in range(torch.cuda.device_count())]
    res = {k: result[k] for k in ("completed", "qps", "p50_ms", "p99_ms", "dispatches", "replays", "mesh")}
    res.update(k1=k1, launches=k1["launches"], keys=sorted(tuple(g["key"]) for g in result["graphs"]))
    log(f"mesh (b): cli.serve.run with serve.data_parallel=true over {result['mesh']}: {result['completed']} "
        f"requests, {result['qps']:.1f} QPS, p50 {result['p50_ms']:.2f} ms, p99 {result['p99_ms']:.2f} ms; "
        f"{result['dispatches']} dispatches, {result['replays']} lane replays; graphs {res['keys']}; K1 "
        f"{k1['launches']} launches, {k1['card']} on the card's own counter")
    if (result["completed"] != MESH_SERVE_REQUESTS or result["shed"] or result["rejected_full"]
            or result["mesh"] != cards or any(g["kind"] != "k" or g["key"][2] != 1 for g in result["graphs"])
            or result["replays"] != result["dispatches"] * len(cards) or k1["replayed"] <= 0):
        raise AssertionError(f"mesh (b): serve.data_parallel through cli.serve.run: {res}")
    return res


def phase_overload(tmp: str) -> dict:
    """(c) bench/serve_bench.py --overload on MobileNetV3-Large 1.0 at 224
    (buckets 1/8/32), its storms cut to OVERLOAD_STORM_S and its gray round
    to OVERLOAD_GRAY_REQUESTS, the storm at OVERLOAD_MULTIPLE: interactive availability higher with the
    brownout ladder on than off, the ladder back at L0, no unresolved
    request in either storm, the straggler soft-ejected with no failed or
    unresolved request. K1's launches are the storm engine's (the line's
    count); the gray round's replicas are processes of their own."""
    log(f"mesh (c): cut: each storm of the overload arm lasts {OVERLOAD_STORM_S:g} s (the bench's default 5 s)")
    log(f"mesh (c): cut: the gray-failure round sends {OVERLOAD_GRAY_REQUESTS} requests (the bench's default 60)")
    log(f"mesh (c): the storm runs at {OVERLOAD_MULTIPLE:g}x the calibrated capacity (the bench's default 3x): "
        "above the paced stack's ceiling on the card, its interactive share below it")
    line = _bench("serve_bench", "--overload", "--overload-storm-s", str(OVERLOAD_STORM_S),
                  "--overload-multiple", str(OVERLOAD_MULTIPLE),
                  "--overload-gray-requests", str(OVERLOAD_GRAY_REQUESTS),
                  "--out", os.path.join(tmp, "overload.json"))
    ov = line["overload"]
    storm, gray, cap = ov["storm"], ov["gray"], ov["capacity"]
    bo = storm["on"]["brownout"]
    res = {"value": line["value"], "availability_off": storm["interactive_availability_off"],
           "availability_on": storm["interactive_availability_on"], "capacity": cap, "requests": ov["requests"],
           "brownout": {k: v for k, v in bo.items() if k != "trace"},
           "shed_at_door": {m: storm[m]["shed_at_door_brownout"] for m in ("off", "on")},
           "unresolved": {m: storm[m]["unresolved"] for m in ("off", "on")},
           "rejected_by_cause": {m: storm[m]["rejected_by_cause"] for m in ("off", "on")},
           "gray": {k: v for k, v in gray.items() if k != "straggler"}, "k1": ov["k1_launches"],
           "launches": ov["k1_launches"]["total"], "seconds": line["_seconds"]}
    log(f"mesh (c): overload arm: capacity {cap['closed_loop_qps']:.1f} QPS closed loop (paced {ov['pace_ms']:g} ms "
        f"a dispatch), a storm of {ov['requests']} requests at {cap['storm_qps']:.1f} QPS: interactive availability "
        f"{res['availability_off']:.4f} brownout off, {res['availability_on']:.4f} on (peak level "
        f"{bo['peak_level']}, back at L{bo['final_level']}, {bo['transitions_up']} up / {bo['transitions_down']} "
        f"down, {res['shed_at_door']['on']} shed at the door); gray round at {gray['target_qps']:.1f} QPS: "
        f"{gray['slow_ejections']} slow ejection(s), {gray['time_to_eject_s']} s to eject, p99 "
        f"{gray.get('p99_ms_before_eject')} ms before and {gray.get('p99_ms_after_eject')} ms after; K1 "
        f"{res['launches']} launches in the storm engine; {line['_seconds']:.1f} s")
    if not (res["availability_on"] > res["availability_off"] and bo["recovered_to_l0"] and bo["final_level"] == 0
            and not any(res["unresolved"].values()) and gray["slow_ejections"] >= 1 and not gray["unresolved"]
            and not gray["failed"] and res["launches"] > 0):
        raise AssertionError(f"mesh (c): the overload arm: {res}")
    return res


DRYRUN_TIMEOUT_S = 600


def _dryrun_one() -> tuple[dict, float]:
    """graft_entry.dryrun_multichip(1) and its seconds."""
    from yet_another_mobilenet_series_tpu_torch import graft_entry

    t0 = time.perf_counter()
    one = graft_entry.dryrun_multichip(1)
    return one, time.perf_counter() - t0


def start_dryrun(pool):
    """(d)'s dry run started on one of ``pool``'s threads: its rank is a
    spawned process of its own, whose start is most of its time, so it runs
    beside phase 14's untimed tuned run and chaos round."""
    return pool.submit(_dryrun_one)


def phase_dryrun(started=None) -> dict:
    """(d) graft_entry.dryrun_multichip(1) (``started``: begun by
    ``start_dryrun``): two AtomNAS steps over NCCL in a rank of its own
    (steps 1 then 2, finite, the replica check 0), and the RuntimeError for
    more ranks than the machine has cards."""
    import torch

    from yet_another_mobilenet_series_tpu_torch import graft_entry

    one, seconds = started.result(timeout=DRYRUN_TIMEOUT_S) if started is not None else _dryrun_one()
    n = torch.cuda.device_count() + 1
    try:
        graft_entry.dryrun_multichip(n)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    r = one["ranks"][0]
    res = {"world": one["world"], "backend": one["backend"], "rank": r, "seconds": seconds, "refused": refused,
           "k1_launches": r["k1_launches"]}
    log(f"mesh (d): dryrun_multichip(1) over {one['backend']} on {r['device']}: steps {r['steps']}, finite "
        f"{r['finite']}, losses {r['loss']}, replica check {r['replica_check']}, K1 {r['k1_launches']} launches, "
        f"{seconds:.1f} s with the spawn{' (beside phase 14 (c) and (e))' if started is not None else ''}; "
        f"dryrun_multichip({n}): {refused}")
    if one["backend"] != "nccl" or refused is None or "cards" not in refused:
        raise AssertionError(f"mesh (d): the dry run: {res}")
    return res


def phase_mesh(device, tmp: str, bundle_dir: str, per_forward: int, dryrun_started=None) -> dict:
    """Phase 15: (b) the serving mesh and serve.data_parallel, (c) the
    overload arm, (d) the data-parallel dry run (``dryrun_started``: begun in
    phase 14). (a), F9, is in phase 13."""
    import torch

    t0 = time.perf_counter()
    lap = _laps("15")
    res = {"engine": phase_mesh_engine(device, bundle_dir, per_forward)}
    torch.cuda.empty_cache()
    res["cli"] = phase_mesh_cli(device, tmp, bundle_dir, per_forward)
    torch.cuda.empty_cache()
    lap("(b) the serving mesh")
    res["overload"] = phase_overload(tmp)
    lap("(c) the overload arm")
    res["dryrun"] = phase_dryrun(dryrun_started)
    lap("(d) the dry run (the rest of it)")
    res["seconds"] = time.perf_counter() - t0
    log(f"mesh: phase 15 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 16: the static analyzer on the card's machine
# ---------------------------------------------------------------------------


# phase 16 (a), the lint gate as tier-1 runs it, in a process of its own
# started with the run (``start_lint``): pure CPU work on the sources, which
# runs beside the card's phases instead of after them
LINT_CHILD = ("import json, time; t0 = time.perf_counter(); "
              "from yet_another_mobilenet_series_tpu_torch.analysis import scope; findings = scope.gate(); "
              "print(json.dumps({'findings': [f.format() for f in findings], 'seconds': time.perf_counter() - t0}))")
LINT_TIMEOUT_S = 300


def start_lint():
    """Phase 16 (a)'s gate, started (``LINT_CHILD``); ``phase_lint`` waits."""
    proc = subprocess.Popen([sys.executable, "-c", LINT_CHILD], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def phase_lint(started) -> dict:
    """Phase 16: (a) the port's lint gate (``analysis/scope.py``), as
    tests/test_torch_port_lint_clean.py runs it, on this machine's Python, in
    the process ``start_lint`` began with the run; any finding fails the
    run; (b) each private torch name that YAMT006 lets through by name or by
    a suppression resolves on this machine's torch. The analyzer reads the
    sources and launches nothing."""
    import torch
    from yet_another_mobilenet_series_tpu_torch.analysis import scope
    from yet_another_mobilenet_series_tpu_torch.analysis.rules_imports import private_names, resolve

    t0 = time.perf_counter()
    proc, t_start = started
    try:
        stdout, stderr = proc.communicate(timeout=LINT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    waited_s = time.perf_counter() - t0
    if proc.returncode or not stdout.strip():
        raise RuntimeError(f"lint: the gate's process exited {proc.returncode}: {stderr[-3000:]}")
    gate = json.loads(stdout.strip().splitlines()[-1])
    findings, gate_s = gate["findings"], gate["seconds"]
    if findings:
        raise RuntimeError(f"lint: the port's gate has {len(findings)} findings:\n" + "\n".join(findings))
    names = private_names(scope.package_paths() + scope.script_paths())
    unresolved = {}
    for name in names:
        try:
            resolve(name, torch)
        except (AttributeError, ImportError) as e:
            unresolved[name] = f"{type(e).__name__}: {e} (used at {', '.join(names[name])})"
    if unresolved:
        raise RuntimeError(f"lint: private torch names that torch {torch.__version__} lacks: {unresolved}")
    seconds = time.perf_counter() - t0
    log(f"lint: phase 16: the gate found {len(findings)} findings in {gate_s:.2f} s (python "
        f"{sys.version.split()[0]}, a process of its own started with the run, waited for {waited_s:.1f} s here); "
        f"{len(names)} private torch names let through resolve on torch {torch.__version__}: {', '.join(names)}; "
        f"phase 16 took {seconds:.1f} s")
    return {"findings": len(findings), "gate_seconds": gate_s, "waited_s": waited_s, "private_names": names,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 17: the zoo's remaining families
# ---------------------------------------------------------------------------

# (arch, its shipped app or None for the arch's defaults, K1 launches a
# forward at 224: one per depthwise stage, one per branch of an AtomNAS block)
FAMILIES = (("mobilenet_v1", "mobilenet_v1", 13), ("mnasnet_a1", "mnasnet_a1_v4_8", 16),
            ("efficientnet_b0", "efficientnet_b0", 16), ("efficientnet_lite0", None, 16),
            ("atomnas_supernet_se", "atomnas_c_se", 51))
FAMILY_BUCKETS = (1, 32)
# bf16 engine logits against the f32 CPU forward, max |diff|: measured once
# at 2.56e-4 (EfficientNet-B0) to 1.355e-3 (EfficientNet-Lite0, max |logit|
# 0.279) over the five nets' seeded weights, buckets 1 and 32, on an NVIDIA
# H100 80GB HBM3 at 700 W; the bar a little under four times the largest
FAMILY_BF16_ATOL = 5e-3
# (e) the C+SE prune event on the card: every PARITY_DEAD_EVERY-th gamma of
# each prunable block below the threshold, and one branch dead whole
FAMILY_PRUNE_THRESHOLD = 0.1
# (f) RandAugment, card against CPU: uint8 batches at 224, every op at
# these magnitudes (both signs for the signed ones), then whole batches of
# the recipe's 2 layers at magnitude 9, timed at RA_TIMED_BATCH
RA_BATCH = 16
RA_MAGNITUDES = (0, 5, 10)
RA_GEOMETRIC = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")  # signed, both signs checked
# tests/test_torch_port_randaugment.py's bar: the geometric ops pick a source
# pixel by rounding float32 coordinates, so an ulp can move a pick at an
# exact .5; at most this share of pixels may differ, every other op exact
RA_GEOMETRIC_MISMATCH = 0.005
RA_TIMED_BATCH = 256
# (g) EfficientNet-B0's recipe on phase 13's TFRecords: the app's 2048 cut
# to one card's RECIPE_BATCH, RECIPE_STEPS steps
RECIPE_APP = os.path.join(REPO, "yet_another_mobilenet_series_tpu_torch", "apps", "efficientnet_b0.yml")
RECIPE_BATCH = 64
RECIPE_STEPS = 6


def family_cfg(arch: str, tmp: str = "", *extra: str):
    """``arch``'s shipped config (FAMILIES) on the fake dataset at IMAGE_SIZE
    on one device, with ``extra`` overrides."""
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli

    app = dict((a, f) for a, f, _ in FAMILIES)[arch]
    head = [f"model.arch={arch}"] if app is None else [
        f"app:{os.path.join(REPO, 'yet_another_mobilenet_series_tpu_torch', 'apps', app + '.yml')}"]
    return parse_cli(head + ["data.dataset=fake", f"data.image_size={IMAGE_SIZE}", "dist.num_devices=1",
                             "dist.sync_bn=false", "dist.shard_optimizer=false",
                             f"train.log_dir={os.path.join(tmp or '.', 'family_' + arch)}", *extra])


def family_net(arch: str):
    from yet_another_mobilenet_series_tpu_torch.models import get_model

    return get_model(family_cfg(arch).model, IMAGE_SIZE)


def phase_family_train_parity(device, tmp: str) -> dict:
    """(a) One f32 step of each family at TRAIN_CHECK_BATCH on the card and
    on the port's CPU path (``_step_parity``: its shipped config in f32,
    dropout and drop_connect off so that no random draw differs, no warmup),
    under phase 8 (a)'s spread rule (``spread``): at init a relu net's
    float32 step turns on the order of its sums (scripts/relu_flips.py shows
    where, one block at a time)."""
    tf32_off("one float32 step of each family, card against CPU")
    out = {}
    for arch, _, _ in FAMILIES:
        cfg = family_cfg(arch, tmp, "train.compute_dtype=float32", "model.dropout=0.0", "model.drop_connect=0.0",
                         "schedule.warmup_epochs=0")
        out[arch] = _step_parity(device, cfg, TRAIN_CHECK_BATCH, arch, spread=True)
    return out


def phase_family_serve(device, tmp: str, arch: str, net, per_forward: int) -> dict:
    """(b) ``arch`` 1.0 (C+SE 1.1) at 224 with seeded weights, exported and
    served by engines on the card at buckets 1 and 32, f32 and bf16, every
    key a CUDA graph captured at warmup; the counts at 0 just before each
    engine and read just after: every graph holds ``per_forward`` K1
    launches a forward, the wrapper launched nothing outside warm runs and
    captures, and the card's own counter equals the accounting. Logits
    against the port's CPU forward of the bundle: f32 at SLICE_ATOL/
    SLICE_RTOL, bf16 within FAMILY_BF16_ATOL."""
    tf32_off("the served logits against the CPU forward at the float32 bar")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle

    branches = sum(1 for blk in net.blocks for _ in blk._branches())
    if branches != per_forward:
        raise AssertionError(f"{arch}: {branches} depthwise branches, FAMILIES says {per_forward}")
    gen = torch.Generator().manual_seed(17)
    params, _ = net.init(gen)
    bundle = load_bundle(export_bundle(net, params, random_bn_state(net, gen), os.path.join(tmp, f"family_{arch}"),
                                       model_name=arch))
    x = np.random.RandomState(18).normal(0, 1, (max(FAMILY_BUCKETS), IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    cpu = InferenceEngine(bundle, device="cpu", buckets=(1, CPU_ROWS))
    want = {1: cpu.predict(x[:1]), CPU_ROWS: cpu.predict(x[:CPU_ROWS])}
    res = {"per_forward": per_forward, "max_logit": float(np.abs(want[CPU_ROWS]).max())}
    for dtype in ("float32", "bfloat16"):
        torch.cuda.synchronize()
        fused_depthwise.launches = 0
        card0 = _k1_on_card()
        engine = InferenceEngine(bundle, device=str(device), buckets=FAMILY_BUCKETS, compute_dtype=dtype)
        engine.warmup()
        got = {b: engine.predict(x[:b]) for b in FAMILY_BUCKETS}
        launches = fused_depthwise.launches
        report = engine.graph_report()
        k1 = _k1_accounting(report, launches, per_forward)
        k1["card"] = _k1_card_gate(card0, k1["launches"], f"{arch} {dtype} engine at buckets {FAMILY_BUCKETS}")
        if sorted(g["key"][0] for g in report) != sorted(FAMILY_BUCKETS) or not all(g["replays"] for g in report):
            raise AssertionError(f"{arch} {dtype}: graphs {report}")
        pairs = [(got[1], want[1]), (got[max(FAMILY_BUCKETS)][:CPU_ROWS], want[CPU_ROWS])]
        if dtype == "float32":
            err = max(_cpu_check(f"{arch} f32 bucket {b}", g, w) for b, (g, w) in zip(FAMILY_BUCKETS, pairs))
        else:
            err = max(float(np.abs(g - w).max()) for g, w in pairs)
            if err > FAMILY_BF16_ATOL or not all(np.isfinite(g).all() for g, _ in pairs):
                raise AssertionError(f"{arch} bf16 engine against the f32 CPU forward: max |diff| {err:.3e}")
        res[dtype] = {"k1": k1, "max_abs_err": err, "graphs": len(report)}
        del engine
    log(f"family {arch} served at {IMAGE_SIZE} (buckets {'/'.join(map(str, FAMILY_BUCKETS))}, every dispatch a graph "
        f"replay): card vs CPU max |err| f32 {res['float32']['max_abs_err']:.3e} (atol {SLICE_ATOL}, rtol "
        f"{SLICE_RTOL}), bf16 {res['bfloat16']['max_abs_err']:.3e} (atol {FAMILY_BF16_ATOL}); max |logit| "
        f"{res['max_logit']:.3e}; K1 {per_forward} a forward, f32 {res['float32']['k1']['launches']} / bf16 "
        f"{res['bfloat16']['k1']['launches']} launches = warm + replays x captured, on the card's own counter")
    return res


def phase_family_prune(device, tmp: str) -> dict:
    """(e) ``apps/atomnas_c_se.yml``'s supernet (1.1x, SE, swish) at 224:
    one prune event on the card and on the CPU from the same gammas (every
    PARITY_DEAD_EVERY-th below FAMILY_PRUNE_THRESHOLD, and one branch of a
    multi-branch block dead whole), the masks equal; the rematerialization
    on the card; the pruned net exported and served by an engine on the
    card (bucket TRAIN_CHECK_BATCH, f32, a CUDA graph), its logits against
    the CPU's folded forward of the bundle within FOLD_ATOL, K1 one launch a
    surviving branch a forward on the card's counter."""
    tf32_off("the pruned net's logits against the CPU's folded forward")
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.models.convert import flatten_tree, unflatten_tree
    from yet_another_mobilenet_series_tpu_torch.models.specs import random_bn_state
    from yet_another_mobilenet_series_tpu_torch.nas import masking, rematerialize
    from yet_another_mobilenet_series_tpu_torch.serve.engine import InferenceEngine
    from yet_another_mobilenet_series_tpu_torch.serve.export import export_bundle, load_bundle

    cfg = family_cfg("atomnas_supernet_se", tmp, "prune.mask_interval=1", "prune.target_flops=0",
                     f"prune.gamma_threshold={FAMILY_PRUNE_THRESHOLD}")
    net = family_net("atomnas_supernet_se")
    gen = torch.Generator().manual_seed(19)
    params, _ = net.init(gen)
    state = random_bn_state(net, gen)
    blocks = masking.prunable_blocks(net)
    other = next(i for i in blocks if len(net.blocks[i].kernel_sizes) > 1)
    off, g = net.blocks[other].group_channels[0], net.blocks[other].group_channels[1]
    for i in blocks:
        gamma = params["blocks"][str(i)]["dw_bn"]["gamma"]
        gamma[::PARITY_DEAD_EVERY] = 0.01
        if i == other:
            gamma[off: off + g] = 0.01  # its second branch dies whole
    events = []
    for dev in (torch.device("cpu"), device):
        p = unflatten_tree({k: v.to(dev) for k, v in flatten_tree(params).items()})
        event = masking.make_prune_event(net, cfg.prune, stop_step=1, device=dev)
        m, _ = event(p, masking.init_masks(net, dev), torch.ones((), device=dev),
                     torch.ones((), dtype=torch.int64, device=dev))
        events.append((m, p))
    (m_cpu, _), (m_card, p_card) = events
    equal = all(torch.equal(m_cpu[k], m_card[k].cpu()) for k in m_cpu)
    s_card = unflatten_tree({k: v.to(device) for k, v in flatten_tree(state).items()})
    new_net, new_p, new_s, _, _, report = rematerialize.rematerialize(net, p_card, s_card, m_card)
    on_card = {k: v.device == device for k, v in flatten_tree(new_p).items()}
    cpu_tree = lambda t: unflatten_tree({k: v.cpu() for k, v in flatten_tree(t).items()})  # noqa: E731
    bundle = load_bundle(export_bundle(new_net, cpu_tree(new_p), cpu_tree(new_s), os.path.join(tmp, "cse_pruned"),
                                       model_name="atomnas_c_se_pruned"))
    per_forward = sum(1 for blk in new_net.blocks for _ in blk._branches())
    x = np.random.RandomState(20).normal(0, 1, (TRAIN_CHECK_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)
    engine = InferenceEngine(bundle, device=str(device), buckets=(TRAIN_CHECK_BATCH,))
    engine.warmup()
    got = engine.predict(x)
    card0 = _k1_on_card()
    for _ in range(SERVED_FORWARDS):
        engine.predict(x)
    counted = _k1_card_gate(card0, per_forward * SERVED_FORWARDS, f"{SERVED_FORWARDS} forwards of the pruned C+SE net")
    want = InferenceEngine(bundle, device="cpu", buckets=(TRAIN_CHECK_BATCH,)).predict(x)
    err = float(np.abs(got - want).max())
    unaligned = [(i, blk.group_channels) for i, blk in enumerate(new_net.blocks)
                 if len(blk.group_channels) > 1 and any(c % 4 for c in blk.group_channels)]
    res = {"masks_equal": equal, "atoms_before": report.atoms_before, "atoms_after": report.atoms_after,
           "dropped_blocks": report.dropped_blocks,
           "dropped_branches": {str(k): v for k, v in report.dropped_branches.items()},
           "rematerialized_on_card": all(on_card.values()), "per_forward": per_forward, "k1_card": counted,
           "max_abs_err": err, "max_logit": float(np.abs(want).max()), "unaligned_branch_blocks": unaligned[:3],
           "se_channels": [blk.se_channels for blk in new_net.blocks]}
    log(f"C+SE prune on the card (atomnas_supernet_se 1.1x at {IMAGE_SIZE}, threshold {FAMILY_PRUNE_THRESHOLD}): the "
        f"event's masks equal the CPU's: {equal}; rematerialized on the card: atoms {report.atoms_before} -> "
        f"{report.atoms_after}, dropped branches {report.dropped_branches}; the pruned net served at bucket "
        f"{TRAIN_CHECK_BATCH} (f32, a CUDA graph): max |err| {err:.3e} against the CPU's folded forward (atol "
        f"{FOLD_ATOL}), max |logit| {res['max_logit']:.3e}; K1 {counted} launches in {SERVED_FORWARDS} forwards on "
        f"the card's counter ({per_forward} surviving branches; unaligned branch slices {unaligned[:2]})")
    if (not equal or not all(on_card.values()) or not report.dropped_branches
            or report.atoms_after >= report.atoms_before or got.shape != want.shape or not np.isfinite(got).all()
            or err > FOLD_ATOL or not unaligned):
        raise AssertionError(f"the pruned C+SE net on the card: {res}")
    return res


def phase_randaugment(device) -> dict:
    """(f) ``data/randaugment.py`` on the card against the CPU from the same
    uint8 batch: every op at RA_MAGNITUDES (both signs for the signed ones),
    then whole batches of the recipe (2 layers at magnitude 9) keyed by
    stream positions, whose draws are integer hashes of (seed, position) on
    the host, so both devices apply the same ops. The bar is
    tests/test_torch_port_randaugment.py's against TF: the geometric ops at
    most RA_GEOMETRIC_MISMATCH of the pixels differing, every other op
    exact; a whole batch the same, image by image, by the ops each image
    drew (``time_randaugment`` times the batch, after phase 16)."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.data import randaugment as ra

    rng = np.random.RandomState(22)
    h = w = IMAGE_SIZE
    x = torch.from_numpy(rng.randint(0, 256, (RA_BATCH, h, w, 3)).astype(np.uint8))
    xd = x.to(device)
    rows, failures = [], []

    def diff(a, b):
        d = (a.to(torch.int16) - b.to(torch.int16)).abs()
        return int(d.max()), float((d.amax(dim=-1) > 0).float().mean())

    for op, name in enumerate(ra.OPS):
        for m in RA_MAGNITUDES:
            for sign in ((1.0, -1.0) if name in RA_GEOMETRIC else (1.0,)):
                d = {"sign": np.full(RA_BATCH, sign, np.float32), "cy": rng.randint(0, h, RA_BATCH),
                     "cx": rng.randint(0, w, RA_BATCH)}
                params = torch.from_numpy(ra.op_params(op, d, float(m), h, w))
                want = ra.apply_op(x, op, float(m), params)
                got = ra.apply_op(xd, op, float(m), params.to(device)).cpu()
                levels, share = diff(got, want)
                rows.append({"op": name, "m": m, "sign": sign, "max_levels": levels, "pixel_share": share})
                if share > (RA_GEOMETRIC_MISMATCH if name in RA_GEOMETRIC else 0.0):
                    failures.append(rows[-1])
    positions = np.arange(1000, 1000 + RA_BATCH)
    want = ra.rand_augment(x, positions, 7, 2, 9.0)
    got = ra.rand_augment(xd, positions, 7, 2, 9.0).cpu()
    groups, idx_rows, _ = ra.plan(7, positions, 2, 9.0, h, w)
    geometric_rows = set()
    for _, op, a, b in groups:
        if ra.OPS[op] in RA_GEOMETRIC:
            geometric_rows.update(int(i) for i in idx_rows[a:b])
    batch_levels, batch_share = diff(got, want)
    per_image = [diff(got[i], want[i]) for i in range(RA_BATCH)]
    for i, (levels, share) in enumerate(per_image):
        if share > (RA_GEOMETRIC_MISMATCH if i in geometric_rows else 0.0):
            failures.append({"batch_image": i, "max_levels": levels, "pixel_share": share})
    worst = max(rows, key=lambda r: (r["pixel_share"], r["max_levels"]))
    res = {"ops_checked": len(rows), "max_levels": max(r["max_levels"] for r in rows),
           "max_pixel_share": worst["pixel_share"], "worst": worst, "batch_max_levels": batch_levels,
           "batch_pixel_share": batch_share, "geometric_images": len(geometric_rows), "rows": rows}
    log(f"RandAugment card vs CPU ({RA_BATCH} uint8 images at {IMAGE_SIZE}): {len(rows)} op cases, largest level "
        f"difference {res['max_levels']}, largest share of pixels differing {res['max_pixel_share']:.5f} "
        f"({worst['op']} m{worst['m']}); the recipe's batch (2 layers, magnitude 9): largest level difference "
        f"{batch_levels}, share "
        f"{batch_share:.5f} ({len(geometric_rows)} images drew a geometric op; bar {RA_GEOMETRIC_MISMATCH} for those, "
        f"0 for the rest)")
    if failures:
        raise AssertionError(f"RandAugment on the card differs from the CPU: {failures[:5]}")
    return res


def time_randaugment(device) -> dict:
    """(f) The recipe's RandAugment (2 layers, magnitude 9) of a uint8 batch
    of RA_TIMED_BATCH at IMAGE_SIZE on the card, back to back."""
    import numpy as np
    import torch

    from yet_another_mobilenet_series_tpu_torch.data import randaugment as ra

    x = torch.from_numpy(np.random.RandomState(23).randint(0, 256, (RA_TIMED_BATCH, IMAGE_SIZE, IMAGE_SIZE, 3))
                         .astype(np.uint8)).to(device)
    positions = np.arange(RA_TIMED_BATCH)
    ms = cuda_time_ms(lambda: ra.rand_augment(x, positions, 7, 2, 9.0), iters=10)
    log(f"RandAugment on the card: {RA_TIMED_BATCH} images at {IMAGE_SIZE} in {ms:.2f} ms a batch "
        f"({RA_TIMED_BATCH / ms * 1e3:.0f} images/s; 2 layers, magnitude 9)")
    return {"ms_per_batch": ms, "images_per_s": RA_TIMED_BATCH / ms * 1e3}


def phase_family_recipe(device, tmp: str) -> dict:
    """(g) ``apps/efficientnet_b0.yml`` (RandAugment 2/9, TF RMSProp, EMA,
    drop_connect 0.2, label smoothing, bf16 as shipped) through
    ``cli/train.py``'s ``train()`` on phase 13's TFRecord shards
    (``<tmp>/jpegs``), RECIPE_STEPS steps at RECIPE_BATCH, under
    ``set_sync_debug_mode("warn")``: every step finite, on the card, no host
    sync inside a step, no K1 launch."""
    import torch

    from yet_another_mobilenet_series_tpu_torch.cli import train as train_cli
    from yet_another_mobilenet_series_tpu_torch.config import parse_cli
    from yet_another_mobilenet_series_tpu_torch.data import randaugment as ra
    from yet_another_mobilenet_series_tpu_torch.ops.fused_depthwise import fused_depthwise

    root = os.path.join(tmp, "jpegs")
    n_train = REAL_CLASSES * REAL_TRAIN_PER_CLASS
    cuts = [f"train.batch_size={RECIPE_BATCH}", f"train.eval_batch_size={RECIPE_BATCH}",
            f"train.epochs={RECIPE_STEPS * RECIPE_BATCH / n_train}", f"train.log_every={RECIPE_STEPS // 2}",
            "train.eval_every_epochs=100", "train.checkpoint_every_epochs=100", "dist.num_devices=1",
            "dist.sync_bn=false"]
    cfg = parse_cli([f"app:{RECIPE_APP}", f"data.data_dir={root}", "data.val_split=val", "data.dataset=imagenet",
                     "data.loader=tfdata", "data.transfer_uint8=true", f"data.num_train_examples={n_train}",
                     f"data.num_eval_examples={REAL_VAL_IMAGES}", f"data.decode_threads={os.cpu_count()}",
                     f"data.image_size={IMAGE_SIZE}", f"train.log_dir={os.path.join(tmp, 'log_recipe')}", *cuts])
    if (cfg.data.randaugment_layers, cfg.data.randaugment_magnitude, cfg.model.drop_connect) != (2, 9, None) \
            or cfg.optim.optimizer != "rmsprop" or not cfg.ema.enable:
        raise AssertionError(f"the recipe changed: {cfg.data}, {cfg.optim}, {cfg.ema}")
    augmented = []  # the device of each batch the device stage augmented
    real_rand_augment = ra.rand_augment

    def counted(images, *a, **k):
        augmented.append(images.device.type)
        return real_rand_augment(images, *a, **k)

    torch.cuda.synchronize()
    fused_depthwise.launches = 0
    ra.rand_augment = counted
    t0 = time.perf_counter()
    try:
        (summary, _, net), syncs = _record_syncs(lambda: train_cli.train(cfg, device=str(device)))
    finally:
        ra.rand_augment = real_rand_augment
    wall = time.perf_counter() - t0
    in_step = [(msg, stack) for msg, stack in syncs if "_one_step" in stack]
    res = {k: v for k, v in summary.items() if k != "log"}
    res.update(wall_s=wall, cuts=cuts, syncs=len(syncs), syncs_in_a_step=len(in_step),
               k1_launches=fused_depthwise.launches, losses=[row["loss"] for row in summary["log"]],
               drop_path_max=max(b.drop_path for b in net.blocks), augmented_batches=len(augmented),
               augmented_on=sorted(set(augmented)))
    log(f"EfficientNet-B0's recipe (cli/train.py, apps/efficientnet_b0.yml: RandAugment 2/9 on the card, TF RMSProp, "
        f"EMA, drop_connect up to {res['drop_path_max']:.3f}, {cfg.train.compute_dtype}; {REAL_TRAIN_SHARDS} TFRecord "
        f"shards of phase 13; cut: {' '.join(cuts)}): {summary['steps']} steps, {summary['finite_steps']} finite, on "
        f"{summary['device']}; log-point losses {[round(v, 4) for v in res['losses']]}; eval top-1 "
        f"{summary['eval_top1']:.4f} over {summary['eval_n']}; {wall:.1f} s; synchronizing calls {len(syncs)}, "
        f"{len(in_step)} inside a step; K1 launches {res['k1_launches']}; RandAugment ran on {len(augmented)} "
        f"batches, on {res['augmented_on']}"
        + "".join(f"; a sync inside a step: {msg} at {' < '.join(reversed(stack[-8:]))}" for msg, stack in in_step[:3]))
    if (summary["steps"] != RECIPE_STEPS or summary["finite_steps"] != RECIPE_STEPS
            or not summary["device"].startswith("cuda") or in_step or res["k1_launches"]
            or len(augmented) < RECIPE_STEPS or res["augmented_on"] != [device.type]):
        raise AssertionError(f"EfficientNet-B0's recipe: {res}")
    return res


def phase_family_checks(device, tmp: str, parity: dict) -> dict:
    """Phase 17's checks, whose gates are bits, bars and counts that a busy
    card cannot move, run beside phase 14 (e)'s chaos round: (b) each
    family served on the card, (c) K1 against its plain version at every
    depthwise branch of the five nets, (e) the C+SE prune event and
    rematerialization, (f) RandAugment against the CPU, (g) EfficientNet-B0's
    recipe; with (a)'s steps (``parity``, run beside the builds)."""
    import torch

    t0 = time.perf_counter()
    lap = _laps("17")
    nets = {arch: family_net(arch) for arch, _, _ in FAMILIES}
    res = {"parity": parity, "serve": {}}
    for arch, _, per_forward in FAMILIES:
        res["serve"][arch] = phase_family_serve(device, tmp, arch, nets[arch], per_forward)
        torch.cuda.empty_cache()
    lap("(b) five families served")
    res["kernel_checks"] = check_net_stages(device, nets, batches=FAMILY_BUCKETS)
    lap("(c) K1 at every branch")
    res["prune"] = phase_family_prune(device, tmp)
    torch.cuda.empty_cache()
    lap("(e) the C+SE prune event")
    res["randaugment"] = phase_randaugment(device)
    lap("(f) RandAugment against the CPU")
    res["recipe"] = phase_family_recipe(device, tmp)
    torch.cuda.empty_cache()
    lap("(g) EfficientNet-B0's recipe")
    res["seconds_beside"] = time.perf_counter() - t0
    return res


def phase_family_times(device, rates, res: dict) -> dict:
    """Phase 17's times, alone on the card after phase 16: (d) K1 at each
    family's stages at batch 32 (phase 3's times) and (f) RandAugment's
    batch; added to ``res`` (``phase_family_checks``)."""
    t0 = time.perf_counter()
    lap = _laps("17")
    res["kernel_times"] = {}
    for arch in (a for a, _, _ in FAMILIES):
        net = family_net(arch)
        log(f"K1 times at {arch}'s {len(net_branch_stages(net, 32))} depthwise branches (contiguous inputs):")
        res["kernel_times"][arch] = time_stages(device, rates, [(n, h, c, k, s, act) for (_, n, h, _, _, c, k, s, act)
                                                                in net_branch_stages(net, 32)])
    lap("(d) K1 timed at the families' stages")
    res["randaugment"].update(time_randaugment(device))
    lap("(f) RandAugment timed")
    res["seconds"] = res["seconds_beside"] + time.perf_counter() - t0
    return res


def _laps(phase: str):
    """A ``lap(step)`` that logs ``time:   <phase> <step> <seconds> s``, the
    seconds since the last lap (or since this call): where a phase's time
    goes, under its ``time:`` line."""
    last = [time.perf_counter()]

    def lap(step: str) -> None:
        now = time.perf_counter()
        log(f"time:   {phase} {step} {now - last[0]:.1f} s")
        last[0] = now

    return lap


class _Took:
    """The ``time:`` line after each group of phases: its seconds and the
    seconds since the run began (``t_start``), for the time limit."""

    def __init__(self, t_start: float):
        self.t_start, self.last = t_start, time.perf_counter()

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        log(f"time: {what} took {now - self.last:.1f} s ({now - self.t_start:.1f} s in all)")
        self.last = now


def write_details(details: dict) -> None:
    out_dir = os.path.join(REPO, "chiprun_out")
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(details, f, indent=1, default=str)
    except OSError as e:  # the details are a convenience; the run's verdict is on stdout
        log(f"could not write chiprun_out/chip_smoke.json: {e}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = card_line()
    if card is None:
        raise RuntimeError("nvidia-smi printed no card")
    log(card)
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True, timeout=60)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc {nvcc.stdout.strip().splitlines()[-1]}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    rates = card_rates(torch.cuda.get_device_name(0))

    took = _Took(t_start)
    # every build and phase 16's gate start now and run beside the card's
    # first phases; the float32 step parities of phases 7 (a), 8 (a) and 17 (a) run
    # no kernel of the port, so they go first, beside the builds
    pool = ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES) + 1)
    builds = start_builds(pool)
    lint_started = start_lint()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            training = {"parity": phase_train_parity(device, tmp)}
            search = {"parity": phase_search_parity(device, tmp)}
            family_parity = phase_family_train_parity(device, tmp)
            took("phases 7 (a), 8 (a) and 17 (a) (the float32 step parities, beside the builds of phases 2 and 13 "
                 "(a) and phase 16's gate)")
            build = phase_build(builds)
            checks = phase_kernel_checks(device, tmp)
            timed = time_stages(device, rates)
            timed_small = time_stages(device, rates, mbv3_depthwise_shapes(32, "mobilenet_v3_small")[1])
            took("phases 1-3 (the rest of the build, kernel checks and times)")
            result = _main_phases(device, tmp, card, rates, {"builds": builds, "lint": lint_started, "pool": pool,
                                                             "family_parity": family_parity}, training, search, took)
    finally:
        if lint_started[0].poll() is None:
            lint_started[0].kill()
            lint_started[0].communicate()
        pool.shutdown(wait=True)
    result.update(build=build, checks=checks, timed=timed, timed_small=timed_small)
    return _report(card, result, t_start)


def _main_phases(device, tmp: str, card: str, rates, started: dict, training: dict, search: dict, took) -> dict:
    """Phases 4-17, after the builds and phase 3 (``main``; ``started``: the
    host library's build, phase 16's gate, the pool that runs phase 15 (d)'s
    dry run beside phase 14, and phase 17 (a)'s steps); phase 17's checks
    run beside phase 14's chaos round, its times after phase 16."""
    import torch

    lap = _laps("4-6")
    served = phase_loads(device, tmp)
    lap("(4) three loads")
    graph_checks = phase_graph_checks(device, tmp, served["bundle_dir"])
    lap("(5) graph checks")
    forward = phase_forward(device, served["bundle_dir"], card, served["per_forward"])
    torch.cuda.empty_cache()
    lap("(6) forward timings")
    took("phases 4-6 (serving)")
    lap = _laps("7")
    training["run"], trained_ts, trained_net = phase_train_run(device, tmp)
    lap("(b) the shipped config through cli/train.py")
    training["export_serve"] = phase_export_serve(device, tmp, trained_ts, trained_net, served["per_forward"])
    del trained_ts
    lap("(d) train -> export -> serve")
    training["overfit"] = phase_overfit(device, tmp)
    torch.cuda.empty_cache()
    lap("(c) overfit")
    training["timing"] = phase_train_timing(device, tmp)
    torch.cuda.empty_cache()
    lap("(e) step timing and profile")
    took("phase 7 (b)-(e) (training)")
    lap = _laps("8")
    search["run"], searched_ts, searched_net, supernet = phase_search_run(device, tmp)
    lap("(b) the search through cli/train.py, steps timed")
    search["masked_vs_remat"] = phase_masked_vs_remat(device, tmp, supernet)
    lap("(c) masked against rematerialized")
    search["serve"] = phase_search_serve(device, tmp, searched_ts, searched_net)
    del searched_ts
    torch.cuda.empty_cache()
    lap("(d) the searched bundle served")
    search["kernel_checks"] = check_net_stages(device, {"supernet": supernet, "searched": searched_net})
    search["kernel_times"] = time_stages(device, rates, [(n, h, c, k, s, act) for (_, n, h, _, _, c, k, s, act)
                                                         in net_branch_stages(searched_net, 32)])
    lap("(e) K1 at the branches")
    search["retrain"] = phase_retrain(device, tmp, search["run"]["searched"]["path"], searched_net)
    lap("(f) the retrain")
    del searched_net, supernet
    torch.cuda.empty_cache()
    took("phase 8 (b)-(f) (the search)")
    benches = phase_benches(device, tmp)
    took("phase 9 (the benches; its --zoo and --fleet arms run beside phases 12 (e) and 11 (a)-(c))")
    tier = phase_serving_tier(device, tmp)
    took("phase 10 (the serving tier)")
    life = phase_life(device, tmp, rates, arm="fleet")
    benches["serve_fleet"] = life.pop("serve_arm")
    torch.cuda.empty_cache()
    took("phase 11 (the life of a run)")
    data_parallel = phase_data_parallel(device, tmp, search["run"]["searched"]["path"], arm="zoo")
    benches["serve_zoo"] = data_parallel.pop("serve_arm")
    torch.cuda.empty_cache()
    took("phase 12 (data parallel, the grouped step)")
    real = phase_real_data(device, tmp, started["builds"]["host"])
    torch.cuda.empty_cache()
    took("phase 13 (the real-data input path)")
    tools = phase_tools(device, tmp, started["pool"],
                        beside=lambda: phase_family_checks(device, tmp, started["family_parity"]))
    families = tools.pop("beside")
    took("phase 14 (the training-side tools; phase 17 (b)-(c) and (e)-(g) beside its chaos round)")
    mesh = phase_mesh(device, tmp, served["bundle_dir"], served["per_forward"], tools.pop("dryrun_started", None))
    took("phase 15 (the serving mesh, the overload arm, the dry run)")
    lint = phase_lint(started["lint"])
    took("phase 16 (the static analyzer)")
    families = phase_family_times(device, rates, families)
    took("phase 17 (d) and (f)'s times (the zoo's remaining families)")
    return {"families": families,
            "served": served, "graph_checks": graph_checks, "forward": forward, "training": training,
            "search": search, "benches": benches, "tier": tier, "life": life, "data_parallel": data_parallel,
            "real": real, "tools": tools, "mesh": mesh, "lint": lint}


def _report(card: str, res: dict, t_start: float) -> int:
    """The closing lines: each path's summary on the card, the ``kernels``
    JSON line, the card line and the result line."""
    import torch

    served, training, search, tier, life = res["served"], res["training"], res["search"], res["tier"], res["life"]
    data_parallel, real, tools, mesh = res["data_parallel"], res["real"], res["tools"], res["mesh"]
    timed, timed_small, checks, forward = res["timed"], res["timed_small"], res["checks"], res["forward"]
    build, graph_checks, benches, lint = res["build"], res["graph_checks"], res["benches"], res["lint"]
    for tag, r in served["loads"].items():
        log(f"load {tag} on {card}: {r['qps']:.1f} QPS, p50 {r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms "
            f"(cli.serve.run: {r['completed']} single-image requests from {SERVE_CLIENTS} closed-loop clients; "
            f"buckets 1/8/32, MobileNetV3-Large 1.0 at 224, f32 compute, {r['traffic']['quant_mode']})")

    tt = training["timing"]
    log(f"training on {card}: MobileNetV3-Large 1.0 at {IMAGE_SIZE}, batch {TRAIN_BATCH}: bf16 "
        f"{tt['bfloat16']['ms_per_step']:.2f} ms per step, {tt['bfloat16']['images_per_s']:.0f} images/s, peak "
        f"{tt['bfloat16']['peak_allocated_gb']:.2f} GB; f32 {tt['float32']['ms_per_step']:.2f} ms, "
        f"{tt['float32']['images_per_s']:.0f} images/s, peak {tt['float32']['peak_allocated_gb']:.2f} GB; device busy "
        f"{100 * tt['bfloat16']['profile']['busy_share']:.1f}% (bf16, profiler); optimizer + EMA "
        f"{100 * tt['bfloat16']['optimizer_ema_share']:.2f}% of a step")

    sr, st = search["run"], search["kernel_times"]["totals"]
    log(f"search on {card}: atomnas_supernet 1.0 at {IMAGE_SIZE}, batch {SEARCH_BATCH}, bf16: "
        f"{sr['supernet_macs'] / 1e6:.1f}M -> {sr['searched']['macs'] / 1e6:.1f}M MACs in {sr['steps']} steps "
        f"({len(sr['remats'])} rematerialization(s)); step {sr['timing']['supernet']['ms_per_step']:.2f} ms "
        f"({sr['timing']['supernet']['images_per_s']:.0f} images/s) on the supernet, "
        f"{sr['timing']['searched']['ms_per_step']:.2f} ms ({sr['timing']['searched']['images_per_s']:.0f} images/s) "
        f"on the searched net; run peak {sr['peak_allocated_gb']:.2f} GB; searched bundle served at "
        f"{search['serve']['qps']:.1f} QPS, K1 {100 * search['serve']['k1_share_of_device_time']:.1f}% of a "
        f"forward's device time")

    fz, ff = tier["front_door"], tier["fleet"]
    log(f"serving tier on {card}: front door HTTP p50 {fz['http_p50_ms']:.2f} ms a sequential request; fleet "
        f"cascade {ff['escalations']} of {FLEET_IMAGES} escalated, {ff['cascade_vs_big_only']:.4f}x big-only's "
        f"dispatched FLOPs per request; kill -9 of the big replica: {ff['kill']['completed']} completed, "
        f"{ff['kill']['typed']} typed, 0 failed, p99 {ff['kill']['p99_ms']:.2f} ms")

    lr_, lc, lv = life["resume"], life["costs"], life["serve"]
    log(f"life of a run on {card}: MobileNetV2 1.0 at {IMAGE_SIZE}; eval-only card vs CPU loss rel "
        f"{life['eval']['loss_rel']:.2e}; killed at step {lr_['preempted']['step']}, resumed to "
        f"{lr_['resumed']['step']}: max |diff| {lr_['diff']:.3e} against the uninterrupted run (two uninterrupted runs "
        f"{lr_['spread']:.3e}); both corruptions fell back one step; a checkpoint {lc['bytes'] / 1e6:.2f} MB, save "
        f"enqueue {lc['saves'][-1]['enqueue_s'] * 1e3:.1f} ms + wait {lc['saves'][-1]['wait_s'] * 1e3:.1f} ms, restore "
        f"{(lc['restore']['spec_s'] + lc['restore']['tree_s']) * 1e3:.1f} ms; step {lc['step_ms']:.2f} ms, "
        f"{lc['step_ms_save_in_flight']:.2f} ms with a save in flight (batch {LIFE_BATCH}, bf16); export_from served "
        f"at {lv['qps']:.1f} QPS")

    dpa, dpd = data_parallel["torchrun"], data_parallel["grouped"]
    log(f"data parallel on {card}: MobileNetV3-Large 1.0 at {IMAGE_SIZE}, bf16, batch {DP_BATCH}: no group "
        f"{dpa['plain']['ms_per_step']} ms per step, torchrun world of 1 (NCCL) {dpa['torchrun']['ms_per_step']}, "
        f"bit for bit; ZeRO max |diff| {data_parallel['zero']['diffs']['params']:.3e}; two gloo ranks max |diff| "
        f"{max(r['params'] for r in data_parallel['gloo']['ranks']):.3e}; grouped K={GROUP_K} (one process): "
        + "; ".join(f"{name} eager {r['timing']['eager_ms_per_step']:.2f} ms, grouped "
                    f"{r['timing']['grouped_ms_per_step']:.2f} ms per step, {r['timing']['kernels_per_replay']} "
                    f"kernels a replay" for name, r in dpd.items()))

    rb, rl, rt = real["build"], {(r["source"], r["uint8"], r["threads"]): r["images_per_s"]
                                 for r in real["loader"]["rows"]}, real["train"]
    cores = os.cpu_count()
    log(f"real data on {card}, host CPU {rb['cpu']} x{rb['cpu_count']}, JPEGs through {rb['codec']}: the loader "
        f"alone {rl[('folder', True, 1)]:.0f} images/s at 1 thread, {rl[('folder', True, cores)]:.0f} at {cores} "
        f"(uint8; f32 {rl[('folder', False, 1)]:.0f} / {rl[('folder', False, cores)]:.0f}; TFRecords "
        f"{rl[('tfrecords', True, cores)]:.0f}); MobileNetV2 1.0 at {IMAGE_SIZE}, bf16, batch {REAL_BATCH}: "
        f"{rt['folder']['ms_per_step']:.1f} ms per step fed by the loader, {rt['fake']['ms_per_step']:.1f} fed by "
        f"the fake stream, device busy {100 * rt['window']['busy_share']:.1f}% in the profiler window; the host "
        f"{'paces' if rt['host_paced'] else 'does not pace'} the step")

    ab, tin, tch = tools["ab"], tools["input"], tools["chaos"]
    base = ab["rows"][0]
    log(f"training-side tools on {card}: bn_bench exact:0 {base['ms_per_step']:.2f} ms a step (MobileNetV3-Large 1.0 at "
        f"{IMAGE_SIZE}, bf16, batch {TOOLS_BN_BATCH}), winner "
        f"{tools['decision']['winner'] and tools['decision']['winner']['bn_mode']}, dispatch tax "
        f"{ab['rows'][-1]['dispatch_tax_ms']:.2f} ms; the tuned cli.train ran {tools['tuned_run']['step_config']!r}; "
        f"input_bench folder {tin['native']['images_per_sec']:.0f} / TFRecords {tin['tfrecord']['images_per_sec']:.0f} "
        f"images/s; train_chaos recovered {tch['value']:.0f} steps after a SIGTERM at step "
        f"{tch['chaos']['killed_step']}")

    me, mo, md = mesh["engine"], mesh["overload"], mesh["dryrun"]
    log(f"serving mesh on {card}: MobileNetV3-Large 1.0 at {IMAGE_SIZE}, f32, bucket 32: "
        + ", ".join(f"{k} {v:.1f} QPS" for k, v in me["qps_bucket32_median"].items())
        + f"; serve.data_parallel through cli.serve.run {mesh['cli']['qps']:.1f} QPS over {mesh['cli']['mesh']}; "
        f"overload arm: interactive availability {mo['availability_off']:.4f} brownout off, "
        f"{mo['availability_on']:.4f} on, straggler ejected in {mo['gray']['time_to_eject_s']} s; "
        f"dryrun_multichip(1) over {md['backend']} finite")

    fam = res["families"]
    log(f"families on {card} at {IMAGE_SIZE}: "
        + "; ".join(f"{arch} served f32 |err| {r['float32']['max_abs_err']:.2e}, bf16 "
                    f"{r['bfloat16']['max_abs_err']:.2e}, K1 {r['per_forward']} a forward, stages "
                    f"{fam['kernel_times'][arch]['totals']['device_ms']:.4f} / "
                    f"{fam['kernel_times'][arch]['totals']['cold_ms']:.4f} ms alone / cold at batch 32 (bound "
                    f"{fam['kernel_times'][arch]['totals']['bound_ms']:.4f})" for arch, r in fam["serve"].items())
        + f"; C+SE pruned on the card ({fam['prune']['atoms_before']} -> {fam['prune']['atoms_after']} atoms) and "
        f"served, |err| {fam['prune']['max_abs_err']:.2e}; RandAugment {fam['randaugment']['images_per_s']:.0f} "
        f"images/s on the card, largest level difference against the CPU {fam['randaugment']['max_levels']}; "
        f"EfficientNet-B0's recipe {fam['recipe']['finite_steps']} finite steps from TFRecords, "
        f"{fam['recipe']['syncs_in_a_step']} host syncs inside a step; phase 17 took {fam['seconds']:.1f} s, "
        f"(b)-(c) and (e)-(g) of them beside phase 14's chaos round")

    t, ts_ = timed["totals"], timed_small["totals"]
    tier_k1 = tier["zoo"]["k1"]
    fam_k1 = {f"{arch} {dtype} engine, buckets 1/32 (phase 17)": r[dtype]["k1"]["launches"]
              for arch, r in fam["serve"].items() for dtype in ("float32", "bfloat16")}
    fam_k1["pruned C+SE net, bucket 8 (phase 17, the card's counter)"] = fam["prune"]["k1_card"]
    stage_keys = ("ms", "device_ms", "cold_ms", "plain_ms", "bound_ms", "library_ms", "library_device_ms",
                  "library_cold_ms", "bf16_ms", "bf16_device_ms", "bf16_cold_ms", "bf16_bound_ms", "bf16_library_ms",
                  "bf16_library_device_ms", "bf16_library_cold_ms", "host_us_per_launch", "library_host_us_per_call")
    real_k1 = real["serve"]
    lt, life_k1 = life["kernel_times"]["totals"], life["serve"]["k1"]
    kernels = {"kernels": [{
        "name": "fused_depthwise",
        "route": "cuda",
        "source": "yet_another_mobilenet_series_tpu_torch/csrc/fused_depthwise.cu",
        "replaces": "yet_another_mobilenet_series_tpu/ops/pallas_kernels.py:129",
        "launches": (served["launches"] + tier_k1["launches"] + life_k1["launches"] + real_k1["launches"]
                     + me["launches"] + mesh["cli"]["launches"] + mo["launches"] + sum(fam_k1.values())),
        "launches_by_load": {**{tag: r["k1"]["launches"] for tag, r in served["loads"].items()},
                             "zoo engine (phase 10)": tier_k1["launches"],
                             "MobileNetV2 through serve.export_from (phase 11)": life_k1["launches"],
                             "MobileNetV2 trained from JPEGs, uint8 wire (phase 13)": real_k1["launches"],
                             **{f"serving mesh check, {k} (phase 15)": n for k, n in me["launches_by_engine"].items()},
                             "cli.serve.run, serve.data_parallel (phase 15)": mesh["cli"]["launches"],
                             "overload arm's storm engine, bench process (phase 15)": mo["launches"], **fam_k1},
        "launches_counted_as": "cli.serve.run's three loads, the zoo engine's traffic, cli.serve.run on the "
                               "checkpoint of phase 11's resumed run, phase 13's cli.serve.run and val crops on "
                               "the checkpoint trained from JPEGs, and phase 15's engines (single, mesh of 1, two "
                               "lanes on one card), cli.serve.run with serve.data_parallel and the overload arm's "
                               "storm engine, phase 17's engines of the five families (f32 and bf16) and the pruned "
                               "C+SE net: warm runs + replays x launches captured, each lane's graph its own "
                               "(counters)",
        "families": {arch: {
            "per_forward": r["per_forward"],
            "launches_f32": r["float32"]["k1"]["launches"], "launches_bf16": r["bfloat16"]["k1"]["launches"],
            "max_abs_err_logits_f32": r["float32"]["max_abs_err"],
            "max_abs_err_logits_bf16": r["bfloat16"]["max_abs_err"],
            "stages": f"the {len(fam['kernel_times'][arch]['rows'])} depthwise branches of {arch} at 224, batch 32 "
                      "(contiguous inputs), times summed",
            **{key: fam["kernel_times"][arch]["totals"][key] for key in stage_keys},
            "bound_by": fam["kernel_times"][arch]["bound_by"]} for arch, r in fam["serve"].items()},
        "families_checks": {"checked_branch_launches": fam["kernel_checks"]["cases"],
                            "scalar_path_launches": fam["kernel_checks"]["scalar_launches"],
                            "max_abs_err": fam["kernel_checks"]["max_f32"],
                            "max_abs_err_bf16": fam["kernel_checks"]["max_bf16"],
                            "pruned_cse_per_forward": fam["prune"]["per_forward"]},
        "launches_on_mesh_path": {
            "a graph of the two-lane mesh, per replay (both lanes; graph report)": me["two_lane_launches_per_replay"],
            "dryrun_multichip(1) rank over NCCL (wrapper count)": md["k1_launches"]},
        "launches_on_real_data_path": {
            "cli.serve.run, uint8 wire (warm + replays x captured)": real_k1["run_k1"]["launches"],
            f"{REAL_VAL_IMAGES} val crops through the engine's graphs (warm + replays x captured)":
                real_k1["k1"]["launches"],
            "MobileNetV2 1.0 per forward on the uint8 wire (the card's counter)": real_k1["card_per_forward"],
            "training run from the folder (wrapper count)": rt["folder"]["k1_launches"]},
        "launches_on_life_path": {
            "MobileNetV2 1.0 per forward (the card's counter)": life["serve"]["card_per_forward"],
            "MobileNetV2 1.0 per forward (graphs: captured launches / captured forwards)":
                life["serve"]["graphs_per_forward"],
            "eval-only run on the card (wrapper count)": life["eval"]["k1_launches"],
            **{f"training run {tag} (wrapper count)": n for tag, n in life["resume"]["k1_launches"].items()}},
        "mbv2_stages": {
            "shapes": "the 17 depthwise stages of MobileNetV2 1.0 at 224 (relu6), batch 32, times summed",
            **{key: lt[key] for key in ("ms", "device_ms", "cold_ms", "plain_ms", "bound_ms", "library_ms",
                                        "library_device_ms", "library_cold_ms", "share", "bf16_ms", "bf16_device_ms",
                                        "bf16_cold_ms", "bf16_bound_ms", "bf16_library_ms",
                                        "bf16_library_device_ms", "bf16_library_cold_ms", "host_us_per_launch",
                                        "library_host_us_per_call")},
            "bound_by": life["kernel_times"]["bound_by"],
            "checked_launches": life["kernel_checks"]["cases"],
            "max_abs_err": life["kernel_checks"]["max_f32"],
            "max_abs_err_bf16": life["kernel_checks"]["max_bf16"]},
        "launches_on_serving_tier": {
            "zoo engine, small (MobileNetV3-Small int8)": tier_k1["by_model"]["small"],
            "zoo engine, big (MobileNetV3-Large f32)": tier_k1["by_model"]["big"],
            "per forward (the card's counter)": tier["zoo"]["card_per_forward"],
            "front door /profile window (profiler)": tier["front_door"]["profiled_k1"]},
        "mbv3_small_stages": {
            "shapes": "the 11 depthwise stages of MobileNetV3-Small 1.0 at 224, batch 32, times summed",
            **{key: ts_[key] for key in ("ms", "device_ms", "cold_ms", "plain_ms", "bound_ms", "library_ms",
                                         "library_device_ms", "library_cold_ms", "share", "bf16_ms", "bf16_device_ms",
                                         "bf16_cold_ms", "bf16_bound_ms", "bf16_library_ms",
                                         "bf16_library_device_ms", "bf16_library_cold_ms")},
            "bound_by": timed_small["bound_by"]},
        "launches_on_device": {**{f"{tag} traffic": r["traffic"]["k1_device_count"]
                                  for tag, r in served["loads"].items()},
                               "5 batch-32 replays": forward["profile"]["fused_dw_count"]},
        "launches_per_replay": {"per_chunk": served["per_forward"], "fused_k": f"{served['per_forward']} x K",
                                "ring": f"{served['per_forward']} x R"},
        "launches_on_training_path": {
            f"cli.train run, {TRAIN_STEPS} steps + EMA eval (wrapper count)": training["run"]["k1_launches"],
            f"{PROFILED_STEPS} bf16 train steps (the card's counter)": tt["bfloat16"]["profile"]["k1_device_count"],
            "trained weights exported and served, per forward (the card's counter)":
                training["export_serve"]["k1_launches"],
            "cli.train run on the tuning file of phase 14 (wrapper count)": tools["tuned_run"]["k1_launches"]},
        "launches_on_search_path": {
            f"cli.train search run, {sr['steps']} steps + EMA evals (wrapper count)": sr["k1_launches"],
            "searched bundle through cli.serve.run (warm runs + replays x captured)":
                search["serve"]["k1"]["launches"],
            "searched bundle, per forward (the card's counter)": search["serve"]["card_per_forward"],
            "surviving branches of the searched net": search["serve"]["per_forward"]},
        "search_stages": {
            "shapes": f"the searched net's {len(search['kernel_times']['rows'])} depthwise branches at batch 32 "
                      "(contiguous inputs), times summed",
            **{key: st[key] for key in ("ms", "device_ms", "cold_ms", "plain_ms", "bound_ms", "library_ms",
                                        "library_device_ms", "library_cold_ms", "bf16_ms", "bf16_device_ms",
                                        "bf16_cold_ms", "bf16_bound_ms", "bf16_library_ms",
                                        "bf16_library_device_ms", "bf16_library_cold_ms")},
            "bound_by": search["kernel_times"]["bound_by"],
            "checked_branch_launches": search["kernel_checks"]["cases"],
            "max_abs_err": search["kernel_checks"]["max_f32"],
            "max_abs_err_bf16": search["kernel_checks"]["max_bf16"]},
        "max_abs_err": checks["max_f32"],
        "max_abs_err_bf16": checks["max_bf16"],
        "ms": t["ms"],
        "kernel_ms": t["ms"],
        "device_ms": t["device_ms"],
        "cold_ms": t["cold_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": timed["bound_by"],
        "share_of_bound_cold": t["share"],
        "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "library_cold_ms": t["library_cold_ms"],
        "library": "F.conv2d(groups=C, bias=shift): conv+bias without the activation",
        "bf16_ms": t["bf16_ms"],
        "bf16_device_ms": t["bf16_device_ms"],
        "bf16_cold_ms": t["bf16_cold_ms"],
        "bf16_bound_ms": t["bf16_bound_ms"],
        "bf16_library_ms": t["bf16_library_ms"],
        "bf16_library_device_ms": t["bf16_library_device_ms"],
        "bf16_library_cold_ms": t["bf16_library_cold_ms"],
        "host_us_per_launch": t["host_us_per_launch"],
        "library_host_us_per_call": t["library_host_us_per_call"],
        "shapes": "the 15 depthwise stages of MobileNetV3-Large 1.0 at 224, batch 32, float32 (bf16_* in bfloat16); times summed; ms = back to back (cuda_time_ms), device_ms = the stream idled while the host enqueues, cold = L2 flushed before each launch",
    }]}
    write_details({"card": card, "build": build, "kernel_rows": timed["rows"], "checks": checks,
                   "small_kernel_rows": timed_small["rows"], "serving_tier": tier,
                   "kernels": kernels,
                   "loads": served, "graph_checks": graph_checks, "forward": forward, "training": training,
                   "search": search, "search_kernel_rows": search["kernel_times"]["rows"], "benches": benches,
                   "life": life, "mbv2_kernel_rows": life["kernel_times"]["rows"], "data_parallel": data_parallel,
                   "real_data": real, "tools": tools, "mesh": mesh, "lint": lint, "families": fam,
                   "family_kernel_rows": {a: r["rows"] for a, r in fam["kernel_times"].items()},
                   "seconds": time.perf_counter() - t_start})
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _nvcc() -> str:
    from yet_another_mobilenet_series_tpu_torch.ops import cuda_build

    return cuda_build.find_nvcc()


if __name__ == "__main__":
    sys.exit(main())
