#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases, each printing its numbers and its wall; any failed check raises,
so the script exits non-zero and prints no result line:

1. card    the GPU's name and power limit (nvidia-smi), torch and CUDA
           versions; no CUDA device is an error;
2. build   nvcc builds every kernel in src/repro_torch/kernels/csrc/, one
           process per source, all started together;
3. gram    the gram kernel against its plain version on the card, at the
           main path's shapes, at tests/test_kernels.py's, with fewer rows
           than the cluster's ranks, at c = 1, at c + 1 = 256 and 257
           and at m = 100,000, f32 and bf16, max |err| / max |ref| ≤ 1e-5
           for G and r, G exactly symmetric, the same bits twice at
           (1000, 45) and (100000, 45); the wide c that sweep the slot map
           in rounds, f32: (1000, 276), (100000, 276), (2000, 1275) and
           (300, 8500), each within 1e-5, symmetric and the same bits
           twice; then at (1000, 45) and (100000, 45) f32 the kernel, the
           kernel as an 8-CTA cluster, the plain version, torch.matmul
           and a launch floor (a one-element add_) timed in turns from
           CUDA graphs and eagerly, beside the bound; then what the
           timing left allocated, by memory pool and stream, is freed;
4. fig2    paper Fig. 2 at paper scale (m = 1000, 100k stars, 20
           iterations) on stripe79 and stripe86; each must reach 90 % of
           the way to the truth by iteration 5 and end within 5e-3 of the
           reference's final fitness, through the gram kernel;
4b. baselines paper §VI through launch/baselines.py at the reference's
           settings (stripe "cmp", 15k stars, ANM at m = 150 + 150 for 25
           iterations, CGD for 150, numerical Newton for 12): ANM reaches
           the target within one iteration of the reference's 6 and ends
           within 5e-3 of its final, CGD does not reach the target by
           ANM's iteration, Newton makes 1 + 209 evaluations an iteration
           and ends no higher than its start (its final moves with the
           fitness's last bits and is printed beside the reference's);
4c. fig3   paper Fig. 3 through launch/fig3.py: 24 one-iteration trials
           (m = 48 + 256, α_max = 30), all escaping the α = 0 basin as
           in the reference, each best fitness within 1e-3 of the
           reference's; best α printed;
5. grid    the 4096-host batched grid on stripe79 (100k stars, m = 1000),
           pipelined and sync, which must commit bit-identical iterates;
6. flash   both attention kernels against their plain version, each case
           on the variant ops.flash_route picks for it: the wgmma variant
           at h2o-danube-3's full shape (2, 4096, 32/8 heads, D = 120,
           bf16, causal, window 8192 and 512), at zamba2's shared block
           (2, 4096, 32/32 heads, D = 80, causal), at D = 128 and 80, at
           S = 300 and 1001 (ragged against its 128-row tiles), D = 64,
           non-causal, and with k and v views into one fused tensor; the
           SIMT variant in f32 at D = 64 and 128, non-causal, and bf16 at
           the danube smoke config's D = 12; max |err| / max |ref| ≤ 2e-2
           (bf16) or 1e-5 (f32), and, since those scale with the largest
           output, ‖err‖ / ‖ref‖ over the tensor ≤ 1e-2 (bf16) or 1e-4
           (f32) and over each output row ≤ 5e-2 (bf16) or 1e-4 (f32);
           bitwise repeatable; at danube's full shape the
           wgmma kernel, the SIMT kernel on the same bf16 inputs, the plain
           version and scaled_dot_product_attention, timed in turns, beside
           the bound, and at zamba2's the wgmma kernel and SDPA;
7. wkv6    both RWKV6 kernels against their plain version, each case on
           the variant ops.wkv6_route picks for it: the chunked variant at
           rwkv6-7b's full shape (2, 4096, 64 heads, K = 64; bf16 r/k/v/u
           with f32 lw), at K = 16, at a T that is no multiple of 16 and at
           both edges of the decay clamp (lw ≡ -3.5 and ≡ -1e-6); the
           serial variant in f32 at the full shape and K = 16, and bf16 at
           K = 8; max |err| / max |ref| ≤ 5e-2 (bf16) or 1e-4 (f32),
           ‖err‖ / ‖ref‖ over the tensor ≤ 1e-2 / 1e-4 and over each
           output row ≤ 5e-2 / 1e-4; bitwise repeatable; at the full shape
           the chunked kernel, the serial kernel on the same bf16 inputs
           and the plain version, timed in turns, beside the bound;
8. lm      act 1 of examples/anm_lm.py over the LM loss at published
           widths: h2o-danube-3-4b cut to 2 layers and rwkv6-7b cut to 1
           (the k = 6 f32 basis must fit; danube's 4 cut to 2 and rwkv6's
           2 to 1 for the smoke's time), 2 x 4096 tokens, one iteration
           (the example's 2 cut for the smoke's time); the θ0 loss
           against the same lane with the kernel swapped for its plain
           version (≤ 2e-2 relative), pipelined == sync bit-identical, a
           lane's loss the same bits in a bucket of 8 and of 32, a finite
           best ≤ the start, and exactly one launch of the arch's kernel
           per layer per lane evaluated (for danube, every one a wgmma
           launch; for rwkv6, every one a chunked launch);
           Then act 2 on danube (2 searches of one iteration each,
           coalesced == solo), launching the kernel once per layer per
           lane evaluated.  After each arch, ``pod lm`` on the same
           workload: for danube the LM backend's mesh route over the
           virtual 16 x 16 mesh (θ0 and the basis stored cut over model,
           gathered at use), act 1 pipelined == [lm]'s in-process sync and
           pipelined, no bucket shape first run after warm; for rwkv6
           launch/dryrun.py's lm_subspace substrate smoke on [lm]'s
           workload and search: sync == pipelined == pod 16 x 16,
           iterates and engine stats, the sync leg == [lm]'s act-1 sync
           run, no new bucket shape after warm; a 2-search portfolio of
           act 2's one iteration through the eval cache == solo, iterates
           and engine stats, its warm replay fully served; the work
           server in-process == pod and crashed at 40 % of its messages,
           restored == uninterrupted; the kernel
           once per layer per lane evaluated in every gate, all chunked;
           then act 1 over 2 gloo ranks sharing this card (each a child
           process building [lm]'s workload from its seeds, the LM
           backend's mesh route on the (2, 1) mesh over the ranks, each
           rank scoring half of every bucket's lanes and all-gathering the
           rest): every rank == [lm]'s in-process sync run, iterates and
           engine stats, its chunked wkv6 launches == its lanes x layers;
           (p1) [lm]'s rwkv6 workload at k = 2 on the (1, 2) mesh over 2
           gloo ranks, the model axis cut over both (each rank keeps its
           model blocks of θ0 and the basis and frees the whole chart;
           before each bucket the cut leaves are all-gathered over the
           model group): 13 given points in buckets of 8 and 5, no warm,
           every rank's values == this process's in-process values bit
           for bit, its stored bytes and each bucket's handed bytes and
           all-gathers == lm_loss.reckon_model_ranks (3,861,196,800 B;
           3,691,704,320 B in 26), chunked wkv6 launches == lanes x
           layers; (p2) rwkv6's smoke configuration's act 1 on the 16 x
           16 mesh over 4 gloo ranks in a (2, 2) grid: every rank == this
           process's in-process sync run, iterates and engine stats, its
           counts as reckoned, half of the one-process pod leg's lanes,
           chunked wkv6 launches == lanes x layers
           (``chip_smoke.py --pod-lm-probe`` runs only (p1) and (p2));
8b. subspace lm  subspace Newton (src/repro/launch/train.py:110's k = 6,
           sample_scale 0.02) on [lm]'s two cut models, weights and batch:
           two steps on the kernel route from one generator, each never
           raising the loss and launching the arch's kernel (m + p + 1)
           times a layer, 146 for danube and 73 for rwkv6; the first
           step again on the plain route (use_kernels=False) from the
           same draws, its losses within 2e-2 of the kernel route's; the
           randomized line search (p = 8) along the first step's
           displacement, its best no worse than α = 1;
9. rowmean the fixed-order row mean against its plain version (the same
           bits) and the float64 mean (≤ 1e-6 relative) at (k, 100000)
           and (k, 4096) for k = 1, 8, 16, 64, 1024, 4096 and at
           (8, 99999); a row's mean the same bits at every position of
           buckets of every width; device ms at (1000, 100000) beside
           torch.mean, the plain version and the bound;
10. fitness the paper-scale SDSS fitness (stripe79, 100k stars): 8 points
           the same bits in buckets of 8 ... 4096 at three positions each
           and alone;
11. server the FGDO work server at paper scale through its command line
           (100k stars, 4096 hosts, m = 1000, 2 iterations): an improving
           commit, gram launched twice per regression phase finish (its
           crash at 40 % and warm restore were cut for the smoke's time:
           the server smoke below crashes and restores warm at the
           reference's size); then
           launch/dryrun.py's server and chaos_server substrate smokes at
           the reference's sizes, every leg a child process of
           server/sim.py on this card: the loopback baseline, --backend
           pod_mesh and the virtual 16 x 16 mesh in this process equal to
           it, three children SIGKILLed mid-run (loopback, TCP, loopback
           with the eval cache, which restores warm) and restored equal
           to it; 8 concurrent TCP clients clean (intake parked) and
           under drop_dup, reorder_delay and reset_torn (faults injected),
           a SIGKILL mid-chaos restored, the pod backend over 16 x 16
           under drop_dup, all equal to the serial baseline; every child
           on the card and launching row_mean;
12. pod    the pod-mesh evaluation backend, on this card's (1, 1) mesh
           and on the production 16 x 16 mesh over 256 virtual devices:
           (a) launch/dryrun.py's pod_mesh substrate smoke at paper scale
           (100k stars, 4096 hosts, m = 1000, 3 iterations), on pod 16 x
           16 and again on pod (1, 1): in-process sync == in-process
           pipelined == pod pipelined, iterates and engine stats, the two
           runs' outcomes equal, no bucket shape first run after warm,
           gram and row_mean in every leg; (a2) with the 16 x 16 run, the
           pod leg over 2 gloo ranks sharing this card, 8 of the 16 data
           shards each (launch/ranks.py: each rank a child process forked
           from the forkserver, evaluating its own row blocks and
           all-gathering the rest): every rank == (a)'s pod leg, iterates
           and engine stats, the ranks' row_mean launches summing to its,
           gram on every rank (each runs the engine); (a3) the same over a
           one-rank NCCL group at (b)'s smoke size (and over two NCCL
           ranks on distinct cards where the machine has two); a failed
           rank fails the smoke; (b) the smoke-size server
           through --backend pod_mesh == in-process, and crashed at 40 %
           on pod 16 x 16, restored ==
           uninterrupted == in-process; (c) the cached_portfolio
           substrate smoke (2 of [portfolio]'s 6 searches) on both
           backends: cache cold == warm == cache off, no miss in the warm
           run, gram and row_mean in every run; each leg prints its wall,
           peak device memory and launches;
13. obs    the observability plane on the work server: at paper scale
           the whole plane (metrics hub, a live subscriber, full tracing,
           retention) == the unobserved server run, gram twice per
           regression finish.  Then launch/dryrun.py's obs_server and
           postmortem substrate smokes at the reference's sizes (48
           hosts, m = 12, 200 stars, 3 iterations, a quarter of the hosts
           silent from t = 150), every leg a child process on this card:
           observed over 8 concurrent TCP clients with a subscriber, and
           under drop_dup, == the unobserved baseline; observed,
           SIGKILLed mid-run and restored == it; the live defense
           shrinks the reliable set and its schedule replays bit for
           bit; replay logs byte-identical with retention and tracing on
           and off; chaotic TCP with retention and tracing SIGKILLed,
           its dead store read by python -m
           repro_torch.launch.obs_postmortem as epoch [1] and after the
           restore (== the baseline) as [1, 2]; the stall window kills
           search 0 and its replay equals it; every server child on the
           card and launching row_mean;
14. portfolio launch/dryrun.py's multi_search substrate smoke at paper
           scale (100k stars, 6 searches at m = 1000 / 500 on the
           4096-host fleet, 2 iterations) on the in-process backend and on
           pod 16 x 16: every search coalesced == solo on both, the
           backends equal search by search (iterates and engine stats),
           fewer dispatches than
           per-search blocks, gram and row_mean on both;
14b. examples the example launchers (launch/{volunteer_grid,train_lm,
           fgdo_service,multi_search,observability,quickstart,serve_lm}.py)
           at their examples' sizes, each through its command line as a
           child process forked from the forkserver, two at once: the
           per-event 256-host grid through FgdoAnmServer and acts 2-3,
           train_lm --fast, the service's four acts (loopback, in-process
           crash and warm restore, TCP, 8 chaotic concurrent clients), the
           portfolio's three director policies, the observability plane's
           three acts, the quickstart bowl and serve_lm's default
           deepseek-v2-lite smoke config; every child exits 0 on this card
           with every gate of its --out doc true, row_mean launched in
           every act that evaluates the SDSS fitness, and gram launched as
           fit_quadratic routes it (never: m·cols ≤ 5760 < 32768);
15. serve  the serving path at published widths, depth cut, bf16 unless
           named: (a) qwen2-72b at 4 layers serves 16 requests at batch 8
           (prompts of 64, 64 generated, max_seq 512) through
           launch/serve.py's loop with top-40 sampling: every request
           gets its tokens inside the vocabulary, no NaN logit; ms per
           decode step (CUDA events around the loop) beside the bound of
           reading the block weights and the head once, one serve step
           replayed from a CUDA graph and the sampler alone (the host's
           share of a step is the rest); peak memory;
           (b) decode == prefill (the attention kernel) over 300 tokens
           in f32 (SIMT) within the reference's 2e-3 and in bf16 (wgmma)
           within 5e-2 normwise, the worst row printed; (c) the same
           tokens through the int8 cache against the bf16 cache, 5e-2
           normwise, and both caches' bytes; (d) deepseek-coder-33b,
           command-r-plus-104b, chameleon-34b, h2o-danube-3-4b and
           rwkv6-7b (2 layers each) serve 8 requests at batch 4 and
           decode == prefill over 64 tokens (rwkv6's through wkv6);
           (s1) danube's weights of (d), drawn from the launcher's seed,
           served over 2 gloo ranks sharing the card through
           launch/serve.py --ranks 2 --model-ranks 2 (the (1, 2) mesh,
           16/4 heads and half the vocabulary a rank, each rank 256 of a
           512-row cache): a prefill of (1, 4096) seeded tokens launching
           the wgmma attention kernel once a layer on each rank's heads,
           within 2e-2 normwise of (d)'s one-process prefill; the decode
           of their first 300 positions within 5e-2 of it; (d)'s serve
           loop, every rank the same tokens inside the vocabulary, no
           NaN logit; every collective kind a rank hands in a decode
           step and in the prefill equal to the dry-run's entries for
           those cells on (1, 2); ms a decode step, gloo's share of it
           and each rank's peak beside the reckoned ones printed
           (``python3 chip_smoke.py --serve-tp-probe`` runs only (s1));
           then danube's smoke config decodes through its ring of 16
           rows against its f32 prefill; (e) hubert-xlarge's encoder forward (2 layers)
           over (2, 512, 1280) frame embeddings on the dense non-causal
           route, bf16 against f32, and the serve loop refusing it; each
           prefill launches its kernel once per layer;
15b. serve moe  MLA and MoE at published widths, bf16 unless named: (f)
           deepseek-v2-lite-16b whole (27 layers) serves 8 requests at
           batch 4 through launch/serve.py, ms per step beside the bound
           of reading every block weight and the head once; one serve
           step replayed from a CUDA graph (a capture refuses a host read
           inside the step) and its peak memory; at MoE capacity 16
           decode == prefill over 64 tokens (5e-2 normwise; the prefill
           launches no kernel: MLA attends densely, as in the
           reference), the int8 latent cache against the bf16 cache
           (5e-2 normwise) with both caches' bytes, the prefill at the
           published capacity the same bits twice; (f') the same arch cut
           to 4 layers in f32: decode == prefill within 2e-3 + 2e-3 |ref|
           and the absorbed decode == the naive one within 2e-4 + 2e-4
           |naive|; (g) llama4-maverick-400b-a17b cut to one dense and one
           MoE layer serves the same way, decode == prefill at capacity 16
           with one wgmma attention launch a layer, and make_loss_fn over
           2 x 4096 seeded tokens at the published capacity on the kernel
           route against the plain route (loss and ce within 1e-3
           relative, aux finite, 2 wgmma launches);
15c. serve hybrid  Mamba2 and the weight-shared attention block:
           (h) zamba2-2.7b whole (54 Mamba2 blocks, 9 applications of the
           shared block; bf16) serves 8 requests at batch 4 through
           launch/serve.py, ms per step beside the bound of reading every
           weight and the caches once; one serve step replayed from a CUDA
           graph and its peak; decode == prefill over 64 tokens with each
           block's decode step fed the prefill's input to that block,
           within 5e-2 normwise on the logits and on every block's output
           (the free decode's gap printed block by block: 63 blocks of
           bf16 rounding drift it by ~5 %), the prefill launching one
           wgmma attention kernel per application (9) and the same bits
           twice; (i) make_loss_fn over 2 x 4096
           seeded tokens on the kernel route against the plain route
           (dense attention) within 1e-3 relative, 9 wgmma launches; (h')
           cut to 14 blocks (12 Mamba2, 2 applications of the one shared
           block) in f32: decode == prefill within 2e-3 + 2e-3 |ref|, 2
           SIMT launches;
15d. train  training through launch/train.py, no kernel launched (the
           launch counters stay at 0; training is use_kernels=False, as
           the reference's launcher) and a backward through a
           use_kernels=True model refused: (t3) h2o-danube-3-4b at its
           published width and depth (3.96 G parameters, bf16, remat),
           three AdamW steps at 8 x 128, ms a step beside the bound
           (AdamW's bytes + 8·N·tokens products) and the peak; (t1)
           lm-100m through train.main with examples/train_lm.py's command
           line (built by launch/train_lm.py) for 100 steps, its loss
           falling by at least TRAIN_LM_MIN_FALL, ms a step, tokens/s,
           peak, checkpoints at 50 and 100; (t2) the tiny preset crashed at step 9 (exit 42) and
           resumed from step 8 in child processes, its step-12 checkpoint ==
           an uninterrupted run's bit for bit; (t4) the tiny preset in
           f32, one step on the card against the CPU from the same weights
           (loss 1e-5 relative, gradients and new parameters 1e-4
           normwise), remat giving the plain backward's bits; (t5)
           benchmarks/train_throughput.py's three numbers on lm-100m and
           the deterministic mode's cost; (t6) --compress-grads for 10
           steps, the loss falling and each residual within a quantum;
           then the data axis over ranks through launch/train.py
           (over_ranks, each rank a child forked from the forkserver):
           (t7) lm-100m over 2 gloo ranks sharing the card, batch 8 x 128
           cut in two, 5 steps: each loss within 2e-2 of the one-process
           step on the hosts' concatenated batches, every rank's
           parameters the same bits after every step, the gradient bytes
           a rank hands its all-reduce x 2 equal to the dry-run's
           data-parallel gradient entries on the (2, 1) mesh, each rank's
           peak within 15 % of the reckoned per-device peak, ms a step
           and the all-reduce's share printed; (t8) the tiny preset over
           a one-rank NCCL group == this process's run bit for bit; (t9)
           the parameters cut over the ranks too (launch/train.py --ranks
           2 --fsdp): h2o-danube-3-4b at published widths cut to 2 layers
           (remat as published), over 2 gloo ranks sharing the card, 3
           AdamW steps at 8 x 128 and lr 1e-4: each loss within 2e-2 of
           the one-process step, the whole leaves the same bits on both
           ranks after every step, the ranks' blocks, put together, within
           2e-2 normwise a leaf of the one-process parameters, the bytes a
           rank hands its all-gathers and reduce-scatters a step equal to
           the dry-run's "(fsdp)" entries on the (2, 1) mesh and its
           whole leaves' all-reduce bytes x 2 to the other gradient
           entries, each rank's peak within 15 % of the reckoned
           per-device peak with fsdp; ms a step, the gathers' and
           reduce-scatters' shares, each rank's peak beside the peak
           reckoned without fsdp, and 24-layer danube's reckoned peak on
           (2, 1) with and without fsdp printed.  ``python3 chip_smoke.py
           --fsdp-probe`` runs only this leg, at danube's published 24
           layers for 2 steps, without the one-process run; (t10) the
           parameters cut over the model axis across the ranks instead
           (launch/train.py --ranks 2 --model-ranks 2, Megatron tensor
           parallelism): (t9)'s danube, batch, steps and lr over 2 gloo
           ranks sharing the card on the (1, 2) mesh (kv heads 8 -> 4 a
           rank; its one data rank draws one host's batch), held
           against the launcher's one-process run: each loss within
           2e-2, the ranks' blocks, put together, within 2e-2 normwise a
           leaf, the whole leaves and the clip norms the same bits on both
           ranks, every kind of collective a rank counts (the model
           group's block, norm, vocab, gradient, exchange, gather and
           stats, the loss's sums and the data-parallel gradient) equal a
           step to the dry-run's entries of that kind on (1, 2) by the
           kind's relation (bytes x 2 for an all-reduce, x M for an
           all-gather, x 1 for an all-to-all; calls for all but the
           gradients', which a rank sums in one buffer a type), each
           rank's peak within 15 % of the reckoned per-device peak on
           (1, 2), no kernel launched in a rank; ms a step, the block
           all-reduces' seconds and share and the vocabulary cut's apart
           printed; (t11) deepseek-v2-lite at published widths cut
           to 3 layers (the dense first layer, 2 MoE layers; remat),
           (t10)'s batch, steps, lr and mesh, MLA's heads, the experts
           and the shared experts cut over the model axis across the 2
           ranks, the experts' buffers exchanged by all-to-alls, held to
           (t10)'s gates, the all-to-alls, the rows' all-gathers (the
           dry-run's "moe gather (port)" entries), the statistics' sums
           and the router's and MLA's latent leaves' gradient sums among
           the kinds; each collective kind's bytes, calls, seconds and
           share and the first step's near-tied tokens printed.  ``python3 chip_smoke.py --tp-moe-probe`` runs
           only (t11); (t12) rwkv6-7b at published widths cut to 2 layers
           and (t13) zamba2-2.7b cut to 7 blocks (6 Mamba2 layers, one
           application of the weight-shared block), each at (t10)'s
           batch, steps, lr and mesh, RWKV6's heads and channel mix,
           Mamba2's inner channels and the shared block cut over the
           model axis across the 2 ranks, held to (t10)'s gates, the norm
           statistics' all-reduces and the time mix's and Mamba2's whole
           leaves' gradient sums among the kinds; each collective kind's
           bytes, calls, seconds and share printed.  ``python3
           chip_smoke.py --tp-ssm-probe`` runs only (t12) and (t13);
15e. dryrun  launch/dryrun.py's reckoning held against real steps, no
           kernel launched: (d1) (t3)'s danube step and (d2) (a)'s
           qwen2-72b decode step at t = 300, each reckoned on meta tensors
           over a (1, 1) mesh of the card and counted once more on the
           card (one extra, untimed step of that phase): the meta trace's
           FLOPs equal to FlopCounterMode's on the card, the reckoned
           peak (argument + the traced peak beside it) within 15 % of the
           step's max_memory_allocated and the traced peak within 3 % of
           the card's rise from the step's start to its peak, and the
           three roofline terms with their bound beside the measured step
           and the hand-written bound (the memory term counts the eager
           step's own op traffic, so it moves with the code);
           (d3) --arch h2o-danube-3-4b --shape train_4k --mesh pod through
           the command line in a child process, exit 0 and its JSON;
16. the card's stamp again (its lines from phase 1), the ``kernels`` JSON
           line (each kernel's ``ranks_launches``: its launches in the
           ranks of [pod] (a2), (a3) and [pod lm], (p1) and (p2) included,
           summed; the attention kernel's ``serve_ranks_launches``: in the
           ranks of [serve] (s1)), then the
           ``ok`` JSON line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.core.engine import identical_trajectories  # noqa: E402
from repro_torch.core.parallel_line_search import (  # noqa: E402
    LineSearchConfig, randomized_line_search)
from repro_torch.core.subspace_newton import (  # noqa: E402
    SubspaceNewtonConfig, init_state, subspace_newton_step)
from repro_torch.core.substrates.batched_grid import \
    BatchedVolunteerGrid  # noqa: E402
from repro_torch.core.substrates.eval_backend import (  # noqa: E402
    InProcessEvalBackend, bucket_size)
from repro_torch.core.substrates.lm_loss import (  # noqa: E402
    LmLossEvalBackend, lm_model)
from repro_torch.core.substrates.pod_mesh import \
    PodMeshEvalBackend  # noqa: E402
from repro_torch.configs import (ShapeConfig, cut_depth,  # noqa: E402
                                 get_config)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.subspace import basis_to_tree  # noqa: E402
from repro_torch.core.tree import leaves_with_paths, map_tree  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.data import sdss  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.core.regression import \
    GRAM_KERNEL_MIN_ELEMENTS  # noqa: E402
# the example launchers are imported here so that the forkserver, which
# preloads this process's modules, starts [examples]' children with them
from repro_torch.launch import (anm_lm, baselines, child,  # noqa: E402,F401
                                dryrun, fgdo_service, fig2, fig3,
                                multi_search, observability, quickstart,
                                ranks, serve, serve_lm, train, train_lm,
                                volunteer_grid)
from repro_torch.launch.mesh import (Mesh, make_production_mesh,  # noqa: E402
                                     virtual_devices)
from repro_torch.models import layers, sharding, transformer  # noqa: E402
from repro_torch.obs import obs_store_path  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.optim.compression import (compress_grads,  # noqa: E402
                                           init_error_state)
from repro_torch.roofline.analysis import (F32_FLOPS, HBM_BW,  # noqa: E402
                                           PEAK_FLOPS)
from repro_torch.server import sim  # noqa: E402


#: (B, S, Hq, Hkv, D, type, causal, window, k/v fused, variant) of the
#: attention checks; the first is h2o-danube-3's full-width shape and the
#: second zamba2's shared block at its published widths (32 heads of 80
#: over 32 KV heads), the two timed.  "k/v fused": k and v are views into
#: one (B, S, 2·Hkv, D) tensor.
FLASH_CASES = [
    (2, 4096, 32, 8, 120, torch.bfloat16, True, 8192, False, "wgmma"),
    (2, 4096, 32, 32, 80, torch.bfloat16, True, 0, False, "wgmma"),
    (2, 4096, 32, 8, 120, torch.bfloat16, True, 512, False, "wgmma"),
    (2, 2048, 16, 4, 128, torch.bfloat16, True, 0, False, "wgmma"),
    (2, 1024, 8, 8, 80, torch.bfloat16, True, 0, False, "wgmma"),
    (1, 300, 4, 2, 120, torch.bfloat16, False, 0, False, "wgmma"),
    (1, 1001, 8, 2, 128, torch.bfloat16, True, 256, False, "wgmma"),
    (1, 1001, 8, 8, 80, torch.bfloat16, False, 0, False, "wgmma"),
    (1, 1001, 4, 2, 64, torch.bfloat16, True, 100, False, "wgmma"),
    (2, 512, 8, 2, 120, torch.bfloat16, True, 0, True, "wgmma"),
    (2, 1024, 8, 2, 64, torch.float32, True, 0, False, "simt"),
    (1, 1024, 4, 4, 128, torch.float32, True, 0, False, "simt"),
    (1, 300, 4, 2, 64, torch.float32, False, 0, False, "simt"),
    (2, 256, 4, 2, 12, torch.bfloat16, True, 0, False, "simt"),
]
#: (B, T, H, K, type of r/k/v/u, lw, variant) of the wkv6 checks (lw is
#: f32: None draws it as the model's range, a number fills it); the first
#: is rwkv6-7b's full-width shape, the one timed
WKV6_CASES = [(2, 4096, 64, 64, torch.bfloat16, None, "chunked"),
              (2, 4096, 64, 64, torch.float32, None, "serial"),
              (2, 256, 4, 16, torch.float32, None, "serial"),
              (2, 256, 4, 16, torch.bfloat16, None, "chunked"),
              (2, 1001, 4, 32, torch.bfloat16, None, "chunked"),
              (2, 1024, 8, 64, torch.bfloat16, -3.5, "chunked"),
              (2, 1024, 8, 64, torch.bfloat16, -1e-6, "chunked"),
              (2, 256, 4, 8, torch.bfloat16, None, "serial")]
#: the LM phase: arch -> layers kept at published widths (a k = 6 f32
#: basis over the parameters must fit on one 80 GB card); rwkv6's cut from
#: 2 to 1 for the smoke's time (its lanes run [lm], [pod lm]'s runner and
#: ranks, and [subspace lm]), danube's from 4 to 2 to make room for [pod
#: lm]'s legs over model ranks
LM_DEPTH = {"h2o-danube-3-4b": 2, "rwkv6-7b": 1}
LM_SEQ_LEN = 4096
#: act 1's iterations (examples/anm_lm.py's 2), cut to one for the
#: smoke's time; [pod lm] and the lm_subspace runner run [lm]'s search
LM_ACT1_ITERATIONS = 1
#: act 2's iterations per search (danube's in [lm], rwkv6's in [pod lm]'s
#: lm_subspace runner), cut to one for the smoke's time (danube's act 2
#: took 72.0 s with two)
LM_ACT2_ITERATIONS = 1
#: [pod lm] rwkv6's act 1 over ranks: gloo ranks sharing this card, each
#: on the (2, 1) mesh's one data position (a model axis of 1 keeps every
#: leaf whole: two ranks' k = 6 f32 bases fit on one 80 GB card)
LM_RANKS = 2
LM_RANKS_MESH = [2, 1]
#: [pod lm] (p1): [lm]'s rwkv6 workload at k = 2 on the (1, 2) mesh over 2
#: gloo ranks, its model axis cut over both: a rank stores half of each
#: cut leaf (a k = 2 f32 basis, so that each bucket's gathers through
#: gloo's host staging take seconds, not minutes); given points in two
#: buckets, 8 then 5 padded to the floor, no warm
LM_P1 = dict(ranks=2, model_ranks=2, mesh=[1, 2], k=2, buckets=(8, 5))
#: [lm]'s workload seed (``sim.lm_problem``'s ``workload_seed``)
LM_WORKLOAD_SEED = 3
#: [pod lm] (p2): act 1 on rwkv6's smoke configuration on the 16 x 16
#: mesh over 4 gloo ranks, the (2, 2) grid (8 x 8 positions a rank)
LM_P2 = dict(ranks=4, model_ranks=2, mesh=[16, 16])


def lm_problem_kw(arch: str) -> dict:
    """``anm_lm.lm_problem``'s arguments for [lm]'s workload and search,
    which the ranks of [pod lm] rebuild from them."""
    return dict(arch=arch, full_width=True, n_layers=LM_DEPTH[arch],
                seq_len=LM_SEQ_LEN, iterations=LM_ACT1_ITERATIONS)

#: the reference's Fig. 2 run (JAX on a CPU, same seeds, 20 iterations):
#: start and truth fitness, final fitness, iteration reaching 90 %
REFERENCE_FIG2 = {
    "stripe79": dict(start=5.30919, truth=5.01094, final=4.98720, at90=1),
    "stripe86": dict(start=5.21282, truth=5.11153, final=5.09539, at90=2),
}

#: every launch counter in kernels/ops.py
LAUNCH_COUNTERS = ("gram_launches", "flash_attention_launches",
                   "flash_attention_wgmma_launches",
                   "flash_attention_simt_launches", "wkv6_launches",
                   "wkv6_chunked_launches", "wkv6_serial_launches",
                   "row_mean_launches")

GRAM_SHAPES = [(1000, 45), (2000, 45),                    # the main path
               (256, 45), (1024, 153), (300, 20), (512, 128),
               (1, 45), (7, 45),        # fewer rows than the cluster's ranks
               (1000, 1),               # c = 1
               (1000, 255), (777, 256),  # c + 1 = 256 and 257 augmented
               (100000, 45)]            # many stages per rank
#: the gram shapes checked for the same bits twice and timed
GRAM_MAIN, GRAM_TALL = (1000, 45), (100000, 45)
#: c above 256: the kernel sweeps its slot map in rounds (f32)
GRAM_WIDE = [(1000, 276), (100000, 276), (2000, 1275), (300, 8500)]

#: row-mean checks: bucket widths, row lengths (stars, quadrature points)
ROW_MEAN_WIDTHS = (1, 8, 16, 64, 1024, 4096)
ROW_MEAN_LENGTHS = (100_000, 4096)
ROW_MEAN_TIMED = (1000, 100_000)
#: the fitness phase's bucket widths
FITNESS_WIDTHS = tuple(2 ** i for i in range(3, 13))
#: the server phase's command line at paper scale (iterations cut to 2)
SERVER_FLAGS = ["--n-stars", "100000", "--n-hosts", "4096", "--m", "1000",
                "--iterations", "2", "--snapshot-every", "5000"]
#: [pod] (a): the pod_mesh substrate smoke at paper scale
SUBSTRATE_GRID = dict(n_stars=100_000, n_hosts=4096, m=1000, iterations=3)
#: [portfolio]: the multi_search substrate smoke at paper scale on both
#: backends, m = 1000 / 500, [portfolio]'s 6 searches
SUBSTRATE_PORTFOLIO = dict(n_searches=6, m=1000, iterations=2,
                           n_stars=100_000, fleet_hosts=4096)
#: [pod] (a2): (a)'s 16 x 16 run over gloo ranks sharing this card; (a3):
#: a one-rank NCCL group at (b)'s smoke size
POD_RANKS = 2
SUBSTRATE_NCCL = dict(n_stars=400, n_hosts=192, m=24, iterations=4)
#: [pod] (c): the cached_portfolio substrate smoke at the same sizes with
#: 2 searches, cut for the smoke's time (the reference's runner takes 8;
#: [portfolio] coalesces 6 at these sizes)
SUBSTRATE_CACHED = dict(SUBSTRATE_PORTFOLIO, n_searches=2)
#: the serve phase: layers kept at published widths per arch (danube's
#: shared with (s1), whose one-process run is (d)'s)
SERVE_DEPTH = {"qwen2-72b": 4, "deepseek-coder-33b": 2,
               "command-r-plus-104b": 2, "chameleon-34b": 2,
               "h2o-danube-3-4b": 2, "rwkv6-7b": 2, "hubert-xlarge": 2,
               "deepseek-v2-lite-16b": 27, "llama4-maverick-400b-a17b": 2}
#: leg (a)'s serve loop, and (d)'s (the reference CLI's defaults)
SERVE_MAIN = dict(requests=16, batch=8, prompt=64, gen=64, max_seq=512)
SERVE_OTHER = dict(requests=8, batch=4, prompt=16, gen=32, max_seq=128)
#: tokens of leg (b) / (c)'s decode == prefill (ragged against the wgmma
#: kernel's 128-row tiles) and of (d)'s
SERVE_MATCH_LEN, SERVE_OTHER_LEN = 300, 64
#: bf16 decode == prefill, ‖decode - prefill‖ / ‖prefill‖ over all
#: positions; the int8 cache's logits against the bf16 cache's, the same
#: way (tests/test_torch_serve_models.py::INT8_TOL)
SERVE_BF16_NORM = 5e-2
SERVE_INT8_NORM = 5e-2
#: (s1): danube at SERVE_DEPTH served over ``ranks`` gloo ranks on the
#: (1, 2) mesh through launch/serve.py, its weights drawn from the
#: launcher's ``seed`` (so (d) serves the same weights in one process);
#: a prefill of ``prefill`` seeded tokens (``token_seed``), the decode of
#: their first ``decode`` positions over a cache of ``max_seq`` rows (256
#: a rank: rank 1's first row is read from t = 256), then (d)'s serve
#: loop; the ranks' prefill held to the one-process prefill, normwise
SERVE_TP = dict(ranks=2, seed=0, prefill=4096, decode=300, max_seq=512,
                token_seed=6)
SERVE_TP_NORM = 2e-2
#: the MoE / MLA phase: deepseek-v2-lite-16b whole (SERVE_DEPTH: all 27
#: layers fit the card in bf16) and llama4-maverick cut to one dense and
#: one MoE layer (one MoE layer's 128 experts are 32.2 GB in bf16); the
#: f32 MLA leg's depth; the MoE capacity at which a 64-token prefill drops
#: nothing (tests/test_models_smoke.py:80-82 raises it to 16 for decode ==
#: prefill); the loss leg's (rows, tokens) at the published capacity and
#: its kernel-route-against-plain-route gate, relative
MLA_F32_DEPTH = 4
MOE_NO_DROP = 16.0
MOE_LOSS_SHAPE = (2, 4096)
MOE_LOSS_TOL = 1e-3
#: bf16 decode == prefill of a MoE model is gated with the decode fed the
#: prefill's experts: in bf16 the two paths' hidden states differ in their
#: last bits, which flips near-tied top-k choices (deepseek-v2-lite at 27
#: layers on an H100: 56 of 64 tokens take another expert somewhere in 26
#: layers of top-6, each first at a prefill margin ≤ 2.0e-3, and the free
#: decode lies 5.4 % from the prefill, the fed one 2.0 %); the free decode
#: is printed, and each token's first flip must come at a near-tie, a
#: prefill margin (k-th minus (k+1)-th router probability) below this
MOE_TIE_MARGIN = 1e-2

#: the hybrid phase: zamba2-2.7b whole (54 Mamba2 blocks and 9
#: applications of its shared attention block, 4.66 GB in bf16), and cut
#: to two of its units (12 Mamba2 blocks, 2 applications of the one
#: shared block) in f32; the loss leg's (rows, tokens)
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_F32_BLOCKS = 14
HYBRID_LOSS_SHAPE = (2, 4096)
HYBRID_LOSS_TOL = 1e-3

#: paper §VI's comparison in the reference (benchmarks/anm_vs_baselines.py,
#: JAX on a CPU, 15k stars): start, truth and target fitness; each method's
#: iteration reaching the target (None: never), evaluations and final
REFERENCE_BASELINES = {
    "start": 5.57915, "truth": 5.17450, "target": 5.27566,
    "anm": dict(at=6, evals=1800, final=5.16571),
    "cgd": dict(at=None, evals=511, final=5.38915),
    "newton_numerical": dict(at=None, evals=2509, final=5.56930),
}
#: Newton's final in the port on the CPU (python -m
#: repro_torch.launch.baselines --device cpu): its last iterations' Hessian
#: moves with the fitness's last bits, so the card's Newton is held to the
#: port's own CPU run, within 1e-3, and printed beside the reference's
PORT_NEWTON_FINAL = 5.49946
#: Fig. 3 in the reference (benchmarks/fig3_linesearch.py, JAX on a CPU):
#: each trial's best fitness, all 24 escaping
REFERENCE_FIG3 = (
    -0.639034, -0.628546, -0.643081, -0.639821, -0.642154, -0.642681,
    -0.642050, -0.628778, -0.623850, -0.636789, -0.626312, -0.639397,
    -0.643431, -0.640613, -0.598712, -0.643621, -0.637655, -0.643030,
    -0.636977, -0.642756, -0.642495, -0.605648, -0.643065, -0.643533)
#: the subspace-Newton legs: src/repro/launch/train.py:110's configuration,
#: [lm]'s weights and batch (make_lm_workload's seed), the generator's
#: seed, and the line search's candidates (train.py --line-search)
SUBSPACE_CFG = SubspaceNewtonConfig(k=6, sample_scale=0.02)
SUBSPACE_WORKLOAD_SEED = 3
SUBSPACE_SEED = 21
SUBSPACE_LINE = LineSearchConfig(p=8)
#: kernel route against plain route, loss by loss at the same points (the
#: m samples and θ of a step from one seed, the line's candidates from
#: another), relative: the two routes' losses differ by ~2.5e-5 on an H100
SUBSPACE_ROUTE_TOL = 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _zero_counts() -> None:
    for name in LAUNCH_COUNTERS:
        setattr(ops, name, 0)


def _counts() -> dict:
    return {name: getattr(ops, name) for name in LAUNCH_COUNTERS}


def phase_card(dev: torch.device) -> None:
    """The card's stamp: nvidia-smi's name and power limit on a line of
    their own, then the device, torch, CUDA and Python versions."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[dev.index or 0].strip()
    print(card)
    print(f"[card] {torch.cuda.get_device_name(dev)} x"
          f"{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} python {sys.version.split()[0]}")


def phase_build() -> None:
    report = build.build_all()
    for name, r in report.items():
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if any(w in ln for w in ("registers", "spill", "arning"))]
        print(f"[build] {name}: {r['seconds']:.2f}s (nvcc sm_90a) "
              + " | ".join(ptxas))


def _time_ms(fn, iters: int = 500) -> float:
    """Per-call time of ``fn`` issued eagerly from Python, with CUDA events
    around ``iters`` calls: what a caller pays, host overhead included."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, calls: int = 100, replays: int = 20) -> float:
    """Per-call device time of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no Python or
    launch overhead of the host is in the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def _events_ms(fn, iters: int = 3) -> float:
    """Per-call time of ``fn`` between CUDA events around ``iters`` eager
    calls, after one warm-up call (for calls too long to graph many)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, that over max |want|), in f32."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / float(want.float().abs().max())


def _gram_bound(m: int, c: int):
    """(bound ms, what bounds it, bytes, FLOP) of one f32 gram call: X and
    y read once, G and r written once; the upper triangle and Xᵀy, FMA = 2
    FLOP, at the f32 peak."""
    moved = 4 * (m * c + m + c * c + c)
    flops = 2 * m * (c * (c + 1) // 2 + c)
    bound_ms, bound_by = _bound(moved, flops, F32_FLOPS)
    return bound_ms, bound_by, moved, flops


def phase_gram(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1234)
    max_abs_err = 0.0
    inputs = {}
    for m, c in GRAM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, c, generator=gen, device=dev).to(dtype)
            y = torch.randn(m, generator=gen, device=dev).to(dtype)
            g, r = ops.gram(x, y)
            g_ref, r_ref = ref.gram_ref(x, y)
            torch.cuda.synchronize()
            for got, want, what in ((g, g_ref, "G"), (r, r_ref, "r")):
                err = float((got - want).abs().max())
                rel = err / float(want.abs().max())
                max_abs_err = max(max_abs_err, err)
                check(rel <= 1e-5, f"gram {what} at ({m}, {c}) {dtype}: "
                      f"max|err|/max|ref| = {rel:.3g} > 1e-5")
            check(torch.equal(g, g.T), f"gram G not symmetric at ({m}, {c})")
            if dtype == torch.float32 and (m, c) in (GRAM_MAIN, GRAM_TALL):
                inputs[m, c] = x, y
    for shape, (x, y) in inputs.items():
        g1, r1 = ops.gram(x, y)
        g2, r2 = ops.gram(x, y)
        check(torch.equal(g1, g2) and torch.equal(r1, r2),
              f"gram is not bitwise repeatable at {shape}")
    wide = []
    for m, c in GRAM_WIDE:
        x = torch.randn(m, c, generator=gen, device=dev)
        y = torch.randn(m, generator=gen, device=dev)
        ms = _events_ms(lambda: ops.gram(x, y), iters=2)
        g, r = ops.gram(x, y)
        g2, r2 = ops.gram(x, y)
        g_ref, r_ref = ref.gram_ref(x, y)
        torch.cuda.synchronize()
        errs = []
        for got, want, what in ((g, g_ref, "G"), (r, r_ref, "r")):
            err, rel = _rel_err(got, want)
            errs.append(rel)
            max_abs_err = max(max_abs_err, err)
            check(rel <= 1e-5, f"gram {what} at ({m}, {c}) f32: "
                  f"max|err|/max|ref| = {rel:.3g} > 1e-5")
        check(torch.equal(g, g.T), f"gram G not symmetric at ({m}, {c})")
        check(torch.equal(g, g2) and torch.equal(r, r2),
              f"gram is not bitwise repeatable at ({m}, {c})")
        sh = ops.gram_shape(c, ops.gram_tile(m, c))
        wide.append(f"({m}, {c}) {sh.rounds} round(s) of {sh.round} "
                    f"slots, G/r rel err {errs[0]:.2e}/{errs[1]:.2e}, "
                    f"{ms:.3f} ms")
        # got holds r, a view of the (c² + c) buffer G lives in
        del x, y, g, r, g2, r2, g_ref, r_ref, got, want
    print(f"[gram] wide c, f32, within 1e-5, symmetric, the same bits "
          f"twice: " + "; ".join(wide))
    lib = build.load("gram")
    room = {(m, c, n): lib.gram_max_active_clusters(
        c, n, ops.gram_stage_rows(c), ops.gram_tile(m, c, n))
        for m, c in (GRAM_MAIN, GRAM_TALL, (777, 256)) for n in (8, 16)}
    one = torch.zeros(1, device=dev)
    dev_ms, call_ms = {}, {}
    for shape in (GRAM_MAIN, GRAM_TALL):
        x, y = inputs[shape]
        fns = {"kernel": lambda: ops.gram(x, y),
               "cluster8": lambda: ops._gram_launch(x, y, 8),
               "plain": lambda: ref.gram_ref(x, y),
               "matmul": lambda: (torch.matmul(x.T, x), torch.matmul(x.T, y)),
               "floor": lambda: one.add_(1.0)}
        # in turns (plain, kernel, kernel, plain), each kept at its best
        order = ["plain", "kernel", "cluster8", "matmul", "floor", "floor",
                 "matmul", "cluster8", "kernel", "plain"]
        for name in order:
            key = (shape, name)
            dev_ms[key] = min(dev_ms.get(key, 1e9), _graph_ms(fns[name]))
            call_ms[key] = min(call_ms.get(key, 1e9), _time_ms(fns[name]))
    bounds = {shape: _gram_bound(*shape) for shape in (GRAM_MAIN, GRAM_TALL)}
    out = dict(max_abs_err=max_abs_err, ms=dev_ms[GRAM_MAIN, "kernel"],
               plain_ms=dev_ms[GRAM_MAIN, "plain"],
               library_ms=dev_ms[GRAM_MAIN, "matmul"],
               bound_ms=bounds[GRAM_MAIN][0], bound_by=bounds[GRAM_MAIN][1],
               floor_ms=dev_ms[GRAM_MAIN, "floor"],
               call_ms=call_ms[GRAM_MAIN, "kernel"],
               library_call_ms=call_ms[GRAM_MAIN, "matmul"],
               ms_100k=dev_ms[GRAM_TALL, "kernel"],
               library_ms_100k=dev_ms[GRAM_TALL, "matmul"],
               bound_ms_100k=bounds[GRAM_TALL][0], cluster=ops.GRAM_CLUSTER)
    print(f"[gram] {len(GRAM_SHAPES) * 2} shape/dtype cases within 1e-5 "
          f"(max abs err {max_abs_err:.3g}), G symmetric, the same bits "
          f"twice at {GRAM_MAIN} and {GRAM_TALL}; clusters that fit at once "
          f"(m, c, CTAs): {room}")
    for shape, (b_ms, b_by, b_moved, b_flops) in bounds.items():
        d = {name: dev_ms[shape, name] for name in
             ("kernel", "cluster8", "plain", "matmul", "floor")}
        e = {name: call_ms[shape, name] for name in
             ("kernel", "cluster8", "plain", "matmul", "floor")}
        tile = ops.gram_tile(*shape)
        print(f"[gram] at {shape} f32, device ms per call (CUDA graph): "
              f"kernel ({ops.GRAM_CLUSTER} CTAs, {tile} x {tile} tiles) "
              f"{d['kernel']:.5f}, 8 CTAs "
              f"{d['cluster8']:.5f}, plain {d['plain']:.5f}, matmul "
              f"{d['matmul']:.5f}, launch floor (one-element add_) "
              f"{d['floor']:.5f}; eager call ms: kernel {e['kernel']:.5f}, "
              f"8 CTAs {e['cluster8']:.5f}, plain {e['plain']:.5f}, matmul "
              f"{e['matmul']:.5f}, floor {e['floor']:.5f}; bound "
              f"{b_ms:.3g} ms ({b_by}: {b_moved} B, {b_flops} FLOP)")
    del inputs, fns, x, y
    _release_timing_memory("gram")
    return out


def _live_blocks() -> dict:
    """Bytes of live allocations by (memory pool, stream), from
    ``torch.cuda.memory_snapshot()``: pool (0, 0) is the default one, any
    other a CUDA graph's private pool."""
    held = {}
    for seg in torch.cuda.memory_snapshot():
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                key = (tuple(seg.get("segment_pool_id", (0, 0))),
                       seg["stream"])
                held[key] = held.get(key, 0) + blk["size"]
    return held


def _release_timing_memory(phase: str) -> None:
    """Free what timing left allocated: graphs and their pools (collected
    with their Python objects), and the cuBLAS workspace torch.matmul
    allocates once for every new stream a graph was captured on.  Prints
    what held memory before and after."""
    gc.collect()
    torch.cuda.synchronize()
    before = _live_blocks()
    torch._C._cuda_clearCublasWorkspaces()   # every stream's workspace
    gc.collect()
    torch.cuda.empty_cache()
    after = _live_blocks()
    print(f"[{phase}] allocated after timing, bytes by (pool, stream): "
          f"{before or 'none'}; after clearing cuBLAS workspaces and "
          f"graph pools: {after or 'none'} "
          f"({torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated)")


def phase_fig2(dev: torch.device) -> int:
    """Fig. 2 at paper scale; returns the gram launches of the run."""
    ops.gram_launches = 0
    results = fig2.run(paper_scale=True, device=dev, iters=20)
    launches = ops.gram_launches
    for name, r in results.items():
        want = REFERENCE_FIG2[name]
        print(f"[fig2] {name}: wall {r['wall_s']:.3f}s, iters_to_90pct "
              f"{r['iterations_to_90pct']} (reference {want['at90']}), "
              f"final {r['final_fitness']:.5f} (reference "
              f"{want['final']:.5f}), truth {r['truth_fitness']:.5f}, "
              f"start {r['start_fitness']:.5f}, evals {r['total_evals']}, "
              f"phase finish {r['phase_finish_ms_mean']:.2f} ms mean, "
              f"peak device memory {r['peak_device_bytes'] / 2**30:.2f} GiB")
        for key in ("start", "truth"):
            got = r[f"{key}_fitness"]
            check(abs(got - want[key]) <= 1e-4 * abs(want[key]),
                  f"{name} {key} fitness {got} vs reference {want[key]}")
        check(r["iterations_to_90pct"] is not None
              and r["iterations_to_90pct"] <= 5,
              f"{name} did not reach 90 % by iteration 5")
        check(abs(r["final_fitness"] - want["final"])
              <= 5e-3 * abs(want["final"]),
              f"{name} final fitness {r['final_fitness']} vs reference "
              f"{want['final']}")
    print(f"[fig2] gram launches {launches}")
    check(launches > 0, "the Fig. 2 run never launched the gram kernel")
    return launches


def phase_grid(dev: torch.device, iters: int = 3) -> None:
    f_batch, x0 = volunteer_grid.make_problem(n_stars=100_000, device=dev)
    backend = InProcessEvalBackend(f_batch, device=dev)
    backend.warm(8, min(volunteer_grid.FLEET.n_hosts,
                        BatchedVolunteerGrid.warm_max_bucket(1000)))
    torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    for mode, pipelined in (("pipelined", True), ("sync", False)):
        ops.gram_launches = 0
        engine, stats, wall = volunteer_grid.run(
            f_batch, x0, m=1000, iters=iters, pipelined=pipelined,
            device=dev, backend=backend)
        out[mode] = dict(engine=engine, stats=stats, wall_s=wall,
                         launches=ops.gram_launches)
        print(f"[grid] {mode}: 4096 hosts, m=1000, {engine.iteration} "
              f"iterations, best {engine.best_fitness:.5f}, wall "
              f"{wall:.3f}s, device_blocked_s {stats.device_blocked_s:.3f}, "
              f"host_s {stats.host_s:.3f}, ticks {stats.ticks}, batches "
              f"{stats.batch_calls}, max in flight {stats.max_in_flight}, "
              f"bucket_hist {dict(sorted(stats.bucket_hist.items()))}, "
              f"gram launches {ops.gram_launches}")
    pipe, sync = out["pipelined"], out["sync"]
    check(identical_trajectories(pipe["engine"], sync["engine"]),
          "pipelined and sync grids committed different iterates")
    check(pipe["engine"].stats == sync["engine"].stats,
          "pipelined and sync grids ended with different engine stats")
    check(pipe["engine"].iteration == iters, "the grid run stopped early")
    check(pipe["launches"] > 0 and sync["launches"] > 0,
          "the grid run never launched the gram kernel")
    check(np.isfinite(pipe["engine"].best_fitness), "non-finite fitness")
    print(f"[grid] pipelined == sync: bit-identical iterates and engine "
          f"stats; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")


def phase_baselines(dev: torch.device) -> int:
    """Paper §VI on the card: launch/baselines.py at the reference's
    settings; returns the row_mean launches of the run (the fitness's)."""
    res, wall, counts, peak = _leg(dev, lambda: baselines.run(device=dev))
    want = REFERENCE_BASELINES
    print(f"[baselines] {res['n_stars']} stars: start {res['start']:.5f} "
          f"(reference {want['start']:.5f}), truth {res['truth']:.5f} "
          f"({want['truth']:.5f}), target {res['target']:.5f} "
          f"({want['target']:.5f}); wall {wall:.1f}s, peak device memory "
          f"{peak:.2f} GiB, launches {counts}")
    for name in ("anm", "cgd", "newton_numerical"):
        r, w = res[name], want[name]
        evals = r.get("evals_total", r.get("evals_to_target"))
        print(f"[baselines] {name}: iterations to target "
              f"{r['iterations_to_target']} (reference {w['at']}), "
              f"{r['iterations']} iterations, evaluations {evals} "
              f"(reference {w['evals']}), final {r['final']:.5f} (reference "
              f"{w['final']:.5f}), wall {r['wall_s']:.2f}s, parallelism "
              f"{r['max_parallelism']}")
    for key in ("start", "truth"):
        check(abs(res[key] - want[key]) <= 1e-4 * abs(want[key]),
              f"baselines {key} fitness {res[key]} vs reference {want[key]}")
    anm, cgd, nw = res["anm"], res["cgd"], res["newton_numerical"]
    at = anm["iterations_to_target"]
    check(at is not None and abs(at - want["anm"]["at"]) <= 1,
          f"ANM reached the target at iteration {at}, the reference at "
          f"{want['anm']['at']}")
    check(abs(anm["final"] - want["anm"]["final"])
          <= 5e-3 * abs(want["anm"]["final"]),
          f"ANM final {anm['final']} vs reference {want['anm']['final']}")
    cat = cgd["iterations_to_target"]
    check(cat is None or cat > at, f"CGD reached the target at iteration "
          f"{cat}, ANM at {at}")
    check(nw["evals_total"] == 1 + 209 * nw["iterations"],
          f"Newton made {nw['evals_total']} evaluations in "
          f"{nw['iterations']} iterations, not 1 + 209 each")
    print(f"[baselines] newton_numerical: final {nw['final']:.5f} against the "
          f"port's CPU run {PORT_NEWTON_FINAL:.5f} (gate 1e-3)")
    check(abs(nw["final"] - PORT_NEWTON_FINAL) <= 1e-3,
          f"Newton final {nw['final']} vs the port's CPU run "
          f"{PORT_NEWTON_FINAL}")
    check(counts["row_mean_launches"] > 0,
          "the baselines never launched the row_mean kernel")
    return counts["row_mean_launches"]


def phase_fig3(dev: torch.device) -> None:
    """Paper Fig. 3 on the card: 24 one-iteration trials, every one
    escaping the α = 0 basin as in the reference, each best fitness within
    1e-3 of the reference's."""
    res, wall, counts, peak = _leg(dev, lambda: fig3.run(device=dev))
    best = [r["best_fitness"] for r in res["samples"]]
    alphas = [r["best_alpha"] for r in res["samples"]]
    worst = max(abs(b - w) for b, w in zip(best, REFERENCE_FIG3))
    print(f"[fig3] {res['trials']} trials: {res['escapes']} escapes "
          f"(reference 24); best fitness {min(best):.6f} ... "
          f"{max(best):.6f}, worst |Δ| against the reference's "
          f"{worst:.2e}; best α {min(alphas):.4f} ... {max(alphas):.4f}; "
          f"wall {wall:.2f}s, peak device memory {peak:.3f} GiB, launches "
          f"{counts}")
    print(f"[fig3] best α per trial: "
          + " ".join(f"{a:.4f}" for a in alphas))
    check(res["escapes"] == len(REFERENCE_FIG3) == res["trials"],
          f"{res['escapes']} of {res['trials']} trials escaped")
    check(worst <= 1e-3, f"a trial's best fitness is {worst} from the "
          f"reference's")


def _bound(moved: int, flops: float, peak: float):
    t_bytes = moved / HBM_BW * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _attention_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps for one (batch, head)."""
    if not causal:
        return s * s
    w = window if window > 0 else s
    return sum(min(i + 1, w) for i in range(s))


def _flash_inputs(b, s, hq, hkv, d, dtype, fused, gen, dev):
    q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype)
    if fused:
        kv = torch.randn(b, s, 2 * hkv, d, generator=gen, device=dev)
        kv = kv.to(dtype)
        return q, kv[:, :, :hkv], kv[:, :, hkv:]
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(dtype)
    return q, k, v


def _norm_rel_err(got: torch.Tensor, want: torch.Tensor):
    """(‖got − want‖ / ‖want‖ over the whole tensor, the largest of that
    over each row of the last axis), in f32.  Unlike max|err|/max|ref|,
    these scale with the values compared: a row that averages many keys
    has a small output, and an error there still shows."""
    diff = (got.float() - want.float()).flatten(0, -2)
    want = want.float().flatten(0, -2)
    row = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return float(diff.norm() / want.norm()), float(row.max())


def phase_flash(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(4321)
    max_abs_err = {"wgmma": 0.0, "simt": 0.0}
    worst = {"wgmma": [0.0, 0.0], "simt": [0.0, 0.0]}   # [norm, row]
    for b, s, hq, hkv, d, dtype, causal, window, fused, variant in FLASH_CASES:
        q, k, v = _flash_inputs(b, s, hq, hkv, d, dtype, fused, gen, dev)
        route = ops.flash_route(q, k, v)
        check(route == variant, f"flash_route gives {route!r} for "
              f"({b}, {s}, {hq}/{hkv}, {d}) {dtype} fused={fused}, want "
              f"{variant!r}")
        before = getattr(ops, f"flash_attention_{variant}_launches")
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        again = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(getattr(ops, f"flash_attention_{variant}_launches")
              == before + 2, f"flash_attention did not launch its {variant} "
              f"kernel")
        err, rel = _rel_err(out, want)
        norm_rel, row_rel = _norm_rel_err(out, want)
        bf16 = dtype == torch.bfloat16
        tol = 2e-2 if bf16 else 1e-5
        norm_tol, row_tol = (1e-2, 5e-2) if bf16 else (1e-4, 1e-4)
        max_abs_err[variant] = max(max_abs_err[variant], err)
        worst[variant] = [max(worst[variant][0], norm_rel),
                          max(worst[variant][1], row_rel)]
        case = (f"({b}, {s}, {hq}/{hkv}, {d}) {dtype} causal={causal} "
                f"window={window} fused_kv={fused}")
        print(f"[flash] {variant} {case}: max|err|/max|ref| {rel:.3g}, "
              f"‖err‖/‖ref‖ {norm_rel:.3g}, worst row ‖err‖/‖ref‖ "
              f"{row_rel:.3g}")
        check(rel <= tol, f"flash_attention {variant} at {case}: {rel:.3g} "
              f"> {tol}")
        check(norm_rel <= norm_tol, f"flash_attention {variant} at {case}: "
              f"‖err‖/‖ref‖ {norm_rel:.3g} > {norm_tol}")
        check(row_rel <= row_tol, f"flash_attention {variant} at {case}: "
              f"worst row ‖err‖/‖ref‖ {row_rel:.3g} > {row_tol}")
        check(torch.equal(out, again), f"flash_attention {variant} is not "
              f"bitwise repeatable at {case}")
        del q, k, v, out, again, want
    dev_ms, bound_ms, bound_by = _flash_timing(
        FLASH_CASES[0], ["plain", "wgmma", "simt", "sdpa", "sdpa", "simt",
                         "wgmma", "plain"], gen, dev)
    hybrid_ms, hybrid_bound, hybrid_by = _flash_timing(
        FLASH_CASES[1], ["wgmma", "sdpa", "sdpa", "wgmma"], gen, dev)
    return dict(variant="wgmma", max_abs_err=max_abs_err["wgmma"],
                ms=dev_ms["wgmma"], plain_ms=dev_ms["plain"],
                library_ms=dev_ms["sdpa"], bound_ms=bound_ms,
                bound_by=bound_by, norm_rel_err=worst["wgmma"][0],
                row_rel_err=worst["wgmma"][1], simt_ms=dev_ms["simt"],
                simt_max_abs_err=max_abs_err["simt"],
                zamba2_ms=hybrid_ms["wgmma"],
                zamba2_library_ms=hybrid_ms["sdpa"],
                zamba2_bound_ms=hybrid_bound, zamba2_bound_by=hybrid_by)


def _flash_timing(case, order, gen, dev):
    """Device ms per call (CUDA graphs) of the variants in ``order`` (in
    turns, each its best) at ``case``'s shape on fresh inputs, and the
    bound: (ms by name, bound ms, what bounds it)."""
    b, s, hq, hkv, d, dtype, causal, window, fused, _ = case
    q, k, v = _flash_inputs(b, s, hq, hkv, d, dtype, fused, gen, dev)
    # SDPA takes (B, H, S, D); the layout change is made once, untimed
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    fns = {"wgmma": lambda: ops.flash_attention(q, k, v, causal=causal,
                                                window=window),
           "simt": lambda: ops._flash_launch(q, k, v, "simt", causal=causal,
                                             window=window),
           "plain": lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                    window=window),
           "sdpa": lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True)}
    check(causal and (window == 0 or window >= s), "a timed case must be "
          "causal with a window covering the sequence (so SDPA's plain "
          "causal mask is the same function)")
    torch.cuda.synchronize()
    err, rel = _rel_err(fns["sdpa"]().transpose(1, 2), fns["plain"]())
    print(f"[flash] SDPA against the plain version at ({b}, {s}, "
          f"{hq}/{hkv}, {d}): {rel:.3g}")
    dev_ms = {}
    for name in order:
        calls, replays = (2, 2) if name in ("plain", "simt") else (10, 5)
        dev_ms[name] = min(dev_ms.get(name, 1e9),
                           _graph_ms(fns[name], calls, replays))
    pairs = _attention_pairs(s, causal, window)
    flops = 4.0 * d * pairs * b * hq             # QKᵀ and PV, FMA = 2
    moved = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
    bound_ms, bound_by = _bound(moved, flops, PEAK_FLOPS)
    timed = ", ".join(f"{name} {dev_ms[name]:.4f}"
                      for name in dict.fromkeys(order))
    print(f"[flash] at ({b}, {s}, {hq}/{hkv}, {d}) {dtype}, device ms per "
          f"call (CUDA graph): {timed}; bound {bound_ms:.4f} ms ({bound_by}: "
          f"{moved} B, {flops:.4g} FLOP at the bf16 tensor-core peak); "
          f"wgmma at {flops / dev_ms['wgmma'] / 1e9:.1f} TFLOP/s")
    del q, k, v, qt, kt, vt
    return dev_ms, bound_ms, bound_by


def _wkv6_inputs(b, t, h, kk, dtype, lw_fill, gen, dev):
    r, k, v = (torch.randn(b, t, h, kk, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    if lw_fill is None:
        lw = (-torch.exp(torch.randn(b, t, h, kk, generator=gen, device=dev))
              ).clamp(-3.5, -1e-6)
    else:
        lw = torch.full((b, t, h, kk), lw_fill, device=dev)
    u = (torch.randn(h, kk, generator=gen, device=dev) * 0.1).to(dtype)
    return r, k, v, lw, u


def phase_wkv6(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(8765)
    max_abs_err = {"chunked": 0.0, "serial": 0.0}
    worst = {"chunked": [0.0, 0.0], "serial": [0.0, 0.0]}   # [norm, row]
    for b, t, h, kk, dtype, lw_fill, variant in WKV6_CASES:
        args = _wkv6_inputs(b, t, h, kk, dtype, lw_fill, gen, dev)
        route = ops.wkv6_route(*args)
        case = (f"({b}, {t}, {h}, {kk}) {dtype} lw "
                f"{'drawn' if lw_fill is None else lw_fill}")
        check(route == variant, f"wkv6_route gives {route!r} for {case}, "
              f"want {variant!r}")
        before = getattr(ops, f"wkv6_{variant}_launches")
        out = ops.wkv6(*args)
        again = ops.wkv6(*args)
        want = ref.wkv6_ref(*args)[0]
        torch.cuda.synchronize()
        check(getattr(ops, f"wkv6_{variant}_launches") == before + 2,
              f"wkv6 did not launch its {variant} kernel")
        err, rel = _rel_err(out, want)
        norm_rel, row_rel = _norm_rel_err(out, want)
        bf16 = dtype == torch.bfloat16
        tol = 5e-2 if bf16 else 1e-4
        norm_tol, row_tol = (1e-2, 5e-2) if bf16 else (1e-4, 1e-4)
        max_abs_err[variant] = max(max_abs_err[variant], err)
        worst[variant] = [max(worst[variant][0], norm_rel),
                          max(worst[variant][1], row_rel)]
        print(f"[wkv6] {variant} {case}: max|err|/max|ref| {rel:.3g}, "
              f"‖err‖/‖ref‖ {norm_rel:.3g}, worst row ‖err‖/‖ref‖ "
              f"{row_rel:.3g}")
        check(bool(torch.isfinite(out.float()).all()),
              f"wkv6 {variant} at {case}: non-finite output")
        check(rel <= tol, f"wkv6 {variant} at {case}: {rel:.3g} > {tol}")
        check(norm_rel <= norm_tol, f"wkv6 {variant} at {case}: "
              f"‖err‖/‖ref‖ {norm_rel:.3g} > {norm_tol}")
        check(row_rel <= row_tol, f"wkv6 {variant} at {case}: worst row "
              f"‖err‖/‖ref‖ {row_rel:.3g} > {row_tol}")
        check(torch.equal(out, again), f"wkv6 {variant} is not bitwise "
              f"repeatable at {case}")
        del args, out, again, want
    b, t, h, kk, dtype, lw_fill, _ = WKV6_CASES[0]
    args = _wkv6_inputs(b, t, h, kk, dtype, lw_fill, gen, dev)
    fns = {"chunked": lambda: ops.wkv6(*args),
           "serial": lambda: ops._wkv6_launch(*args, "serial"),
           "plain": lambda: ref.wkv6_ref(*args)[0]}
    dev_ms = {}
    for name in ["plain", "chunked", "serial", "serial", "chunked", "plain"]:
        calls, replays = (1, 2) if name == "plain" else (20, 5)
        dev_ms[name] = min(dev_ms.get(name, 1e9),
                           _graph_ms(fns[name], calls, replays))
    r, _, _, lw, u = args
    moved = (3 * r.numel() * r.element_size() + lw.numel() * 4
             + u.numel() * u.element_size() + r.numel() * r.element_size())
    # the chunked form's products per 16-step chunk and (b, h), FMA = 2:
    # scores and A v (2 C² K each), the cross term and the state's
    # increment (2 C K² each), at the bf16 tensor-core peak
    n_chunks = -(-t // 16)
    flops = (4.0 * 16 * 16 * kk + 4.0 * 16 * kk * kk) * n_chunks * b * h
    bound_ms, bound_by = _bound(moved, flops, PEAK_FLOPS)
    # the sequential form's 5 K² f32 FLOP per step and (b, h): the bound
    # of the serial kernel, printed beside
    seq_ms, _ = _bound(moved, 5.0 * kk * kk * t * b * h, F32_FLOPS)
    print(f"[wkv6] at ({b}, {t}, {h}, {kk}) {dtype}, device ms per call "
          f"(CUDA graph): chunked {dev_ms['chunked']:.4f}, serial "
          f"{dev_ms['serial']:.4f}, plain {dev_ms['plain']:.4f}; bound "
          f"{bound_ms:.4f} ms ({bound_by}: {moved} B, {flops:.4g} FLOP at "
          f"the bf16 tensor-core peak; the sequential form at the f32 peak "
          f"{seq_ms:.4f}); chunked at {moved / dev_ms['chunked'] / 1e6:.1f} "
          f"GB/s")
    return dict(variant="chunked", max_abs_err=max_abs_err["chunked"],
                ms=dev_ms["chunked"], plain_ms=dev_ms["plain"],
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                norm_rel_err=worst["chunked"][0],
                row_rel_err=worst["chunked"][1], serial_ms=dev_ms["serial"],
                serial_max_abs_err=max_abs_err["serial"])


#: arch -> (the launch counter every launch of its kernel must show, the
#: ops function the model calls, the plain version in the model's layout);
#: danube's must all be launches of the wgmma variant, rwkv6's of the
#: chunked one
LM_KERNEL = {
    "h2o-danube-3-4b": ("flash_attention_wgmma_launches", "routed_attention",
                        lambda q, k, v, *, causal, window:
                        ref.flash_attention_ref(q, k, v, causal, window)),
    "rwkv6-7b": ("wkv6_chunked_launches", "routed_wkv6",
                 lambda r, k, v, lw, u: ref.wkv6_ref(r, k, v, lw, u)[0]),
}


@contextlib.contextmanager
def _plain_route(arch: str):
    """The model's kernel call swapped for its plain version (a check of
    the whole forward, outside the counted run)."""
    _, name, plain = LM_KERNEL[arch]
    kernel = getattr(ops, name)
    setattr(ops, name, plain)
    try:
        yield
    finally:
        setattr(ops, name, kernel)


def _lane_split_ms(backend: LmLossEvalBackend, c: torch.Tensor) -> dict:
    """Device ms, with CUDA events, of one whole lane (lift, forward, LM
    head and cross-entropy), of its lift alone and of its head alone (the
    final hidden states through the LM head and the cross-entropy)."""
    wl = backend.workload
    with torch.no_grad():
        params = wl.proj.lift(c)                 # a second working set
        hidden = transformer.forward(params, wl.cfg, wl.batch)[0]
        w_head = params["head"]["w"]
        return {
            "lane": _events_ms(lambda: backend.lane_loss(c)),
            "lift": _events_ms(lambda: wl.proj.lift(c, out=params)),
            "head": _events_ms(lambda: transformer.chunked_cross_entropy(
                hidden, w_head, wl.batch["labels"])),
        }


def phase_lm(dev: torch.device, arch: str, kernel_ms: float):
    """Act 1 over ``arch``'s loss at published widths (and act 2 for
    danube); returns the arch's kernel launches in the two act-1 runs,
    and what ``[pod lm]`` reuses: the workload, its search and act 1's
    engines."""
    counter = LM_KERNEL[arch][0]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    search, fleet, wl = anm_lm.lm_problem(device=dev, **lm_problem_kw(arch))
    torch.cuda.synchronize()
    n_layers = wl.cfg.n_layers          # every layer runs the arch's kernel
    n_params = wl.proj.n_params
    basis_bytes = wl.proj.basis.numel() * wl.proj.basis.element_size()
    print(f"[lm] {arch}: {n_layers} layers at published widths, P = "
          f"{n_params}, basis {basis_bytes / 1e9:.2f} GB (k = {wl.k}, f32), "
          f"batch {tuple(wl.batch['tokens'].shape)}, built in "
          f"{time.perf_counter() - t0:.1f}s")
    backend = anm_lm.warmed_backend(wl, search.anm.m_regression)
    zero = torch.zeros(wl.k, device=dev)
    loss0 = float(backend.lane_loss(zero))
    with _plain_route(arch):
        loss0_plain = float(backend.lane_loss(zero))
    rel = abs(loss0 - loss0_plain) / abs(loss0_plain)
    print(f"[lm] {arch}: loss at θ0 {loss0:.6f} (ln vocab "
          f"{math.log(wl.cfg.vocab_size):.6f}); with the plain version in "
          f"place of the kernel {loss0_plain:.6f} (relative {rel:.3g})")
    check(math.isfinite(loss0), f"{arch}: non-finite loss at θ0")
    check(rel <= 2e-2, f"{arch}: θ0 loss through the kernel {loss0} vs the "
          f"plain version {loss0_plain}")

    _zero_counts()                  # the main path, counted from 0
    out = {}
    for mode, pipelined in (("pipelined", True), ("sync", False)):
        engine, stats, wall = anm_lm.run(search, fleet, backend,
                                         pipelined=pipelined)
        lanes = sum(kp * n for kp, n in stats.bucket_hist.items())
        out[mode] = dict(engine=engine, stats=stats, lanes=lanes)
        print(f"[lm] {arch} {mode}: {engine.iteration} iterations, best "
              f"{engine.best_fitness:.6f} (start {loss0:.6f}), wall "
              f"{wall:.2f}s, {stats.batch_calls} buckets, {lanes} lanes, "
              f"device_blocked_s {stats.device_blocked_s:.2f}, host_s "
              f"{stats.host_s:.2f}, bucket_hist "
              f"{dict(sorted(stats.bucket_hist.items()))}")
    launches = getattr(ops, counter)
    pipe, sync = out["pipelined"], out["sync"]
    lanes = pipe["lanes"] + sync["lanes"]
    counts = _counts()
    print(f"[lm] {arch}: {counter} {launches} for {lanes} lanes x "
          f"{n_layers} layers; all counts {counts}")
    check(launches == lanes * n_layers, f"{arch}: {launches} kernel "
          f"launches, want one per layer per lane ({lanes} x {n_layers})")
    check(counts["flash_attention_launches"]
          == counts["flash_attention_wgmma_launches"],
          f"{arch}: an attention launch took the SIMT variant")
    check(counts["wkv6_launches"] == counts["wkv6_chunked_launches"],
          f"{arch}: a wkv6 launch took the serial variant")
    check(launches > 0, f"{arch}: the act-1 runs never launched the kernel")
    check(identical_trajectories(pipe["engine"], sync["engine"]),
          f"{arch}: pipelined and sync committed different iterates")
    check(pipe["engine"].stats == sync["engine"].stats,
          f"{arch}: pipelined and sync ended with different engine stats")
    check(pipe["engine"].iteration == search.anm.max_iterations,
          f"{arch}: act 1 stopped early")
    best = pipe["engine"].best_fitness
    check(math.isfinite(best) and best <= loss0,
          f"{arch}: best {best} is not a finite loss ≤ the start {loss0}")

    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.3, 0.3, (20, wl.k))
    narrow = backend(pts[:3])                   # a bucket of 8
    wide = backend(pts)                         # a bucket of 32
    check(np.array_equal(narrow, wide[:3]),
          f"{arch}: a lane's loss depends on its bucket's width")
    split = _lane_split_ms(backend, torch.from_numpy(pts[0]).float().to(dev))
    kernel_lane = kernel_ms * n_layers
    print(f"[lm] {arch}: a lane's loss is the same bits in buckets of 8 and "
          f"32; device ms per lane {split['lane']:.2f}: lift "
          f"{split['lift']:.2f}, kernel {kernel_lane:.2f} ({n_layers} x "
          f"{kernel_ms:.3f}), LM head + CE {split['head']:.2f}, the rest "
          f"(projections, MLP/channel mix, norms, elementwise) "
          f"{split['lane'] - split['lift'] - kernel_lane - split['head']:.2f}"
          f"; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; phase "
          f"wall {time.perf_counter() - t0:.1f}s")
    if arch != "rwkv6-7b":
        _lm_act2(dev, arch, search, fleet, backend, n_layers)
    torch.cuda.synchronize()
    del backend
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(search=search, fleet=fleet, wl=wl,
                          sync=sync["engine"], pipe=pipe["engine"],
                          n_layers=n_layers)


def _row_mean_bound(k: int, n: int):
    """(bound ms, what bounds it) of one row_mean call: the (k, n) f32
    input read once, k f32 written; one f64 add per element at f32's
    peak (the f64 rate is lower, and still far below the bytes)."""
    return _bound(4 * (k * n + k), float(k * n), F32_FLOPS)


def phase_rowmean(dev: torch.device) -> dict:
    """The fixed-order row mean against its plain version and float64."""
    gen = torch.Generator(device=dev).manual_seed(77)
    max_abs_err, worst_rel, cases = 0.0, 0.0, 0
    shapes = [(k, n) for n in ROW_MEAN_LENGTHS for k in ROW_MEAN_WIDTHS]
    for k, n in shapes + [(8, 99_999)]:
        x = torch.rand(k, n, generator=gen, device=dev) * 4.0 - 1.0
        got = ops.row_mean(x)
        plain = ref.row_mean_ref(x)
        want = x.double().mean(dim=1)
        scale = x.double().abs().mean(dim=1)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        rel = float(((got.double() - want).abs() / scale).max())
        max_abs_err, worst_rel = max(max_abs_err, err), max(worst_rel, rel)
        check(rel <= 1e-6, f"row_mean at ({k}, {n}): {rel:.3g} of the mean "
              f"|x| from the float64 mean, > 1e-6")
        check(torch.equal(got, plain), f"row_mean at ({k}, {n}) is not its "
              f"plain version's bits (max |err| {err:.3g})")
        cases += 1
    # a row's mean is its own: every width, every position
    placed = 0
    for n in ROW_MEAN_LENGTHS:
        x = torch.randn(max(ROW_MEAN_WIDTHS), n, generator=gen, device=dev)
        full = ops.row_mean(x)
        for k in ROW_MEAN_WIDTHS:
            for start in sorted({0, (len(x) - k) // 2, len(x) - k}):
                part = ops.row_mean(x[start:start + k].contiguous())
                check(torch.equal(part, full[start:start + k]),
                      f"row_mean of rows {start}..{start + k} of ({len(x)}, "
                      f"{n}) depends on the bucket")
                placed += 1
        del x, full
    k, n = ROW_MEAN_TIMED
    x = torch.randn(k, n, generator=gen, device=dev)
    fns = {"kernel": lambda: ops.row_mean(x),
           "plain": lambda: ref.row_mean_ref(x),
           "mean": lambda: torch.mean(x, dim=1)}
    dev_ms = {}
    for name in ("plain", "kernel", "mean", "mean", "kernel", "plain"):
        calls = 5 if name == "plain" else 50
        dev_ms[name] = min(dev_ms.get(name, 1e9),
                           _graph_ms(fns[name], calls=calls, replays=5))
    bound_ms, bound_by = _row_mean_bound(k, n)
    print(f"[rowmean] {cases} shapes: the plain version's bits, within "
          f"{worst_rel:.2e} (≤ 1e-6) of the float64 mean relative to the "
          f"mean |x|; {placed} sub-buckets of widths {ROW_MEAN_WIDTHS} at "
          f"three positions each: the same bits as in the full batch")
    print(f"[rowmean] at {ROW_MEAN_TIMED} f32, device ms per call (CUDA "
          f"graph): kernel {dev_ms['kernel']:.5f}, torch.mean "
          f"{dev_ms['mean']:.5f}, plain {dev_ms['plain']:.5f}; bound "
          f"{bound_ms:.5f} ({bound_by}: {4 * (k * n + k)} B)")
    del x, fns
    _release_timing_memory("rowmean")
    return dict(max_abs_err=max_abs_err, ms=dev_ms["kernel"],
                plain_ms=dev_ms["plain"], bound_ms=bound_ms,
                bound_by=bound_by, library_ms=dev_ms["mean"],
                max_rel_err_f64=worst_rel)


def phase_fitness(dev: torch.device) -> None:
    """The contract itself: a lane's fitness is its own bytes' function."""
    f_batch, _ = sdss.make_fitness(sdss.stripe79(), dev)
    rng = np.random.default_rng(5)
    pts = rng.uniform(sdss.LO, sdss.HI,
                      (max(FITNESS_WIDTHS), 8)).astype(np.float32)
    probe = pts[:8].copy()
    base = f_batch(probe).cpu()
    check(bool(torch.isfinite(base).all()), "non-finite SDSS fitness")
    alone = torch.stack([f_batch(probe[i:i + 1]).cpu()[0] for i in range(8)])
    check(torch.equal(alone, base), "a point's fitness alone differs from "
          "its fitness in a bucket of 8")
    placed = 0
    for k in FITNESS_WIDTHS:
        for pos in sorted({0, (k - 8) // 2, k - 8}):
            block = pts[:k].copy()
            block[pos:pos + 8] = probe
            got = f_batch(block).cpu()[pos:pos + 8]
            check(torch.equal(got, base), f"fitness at position {pos} of a "
                  f"bucket of {k} differs from the bucket of 8 (max "
                  f"{float((got - base).abs().max()):.3g})")
            placed += 1
    print(f"[fitness] stripe79 at 100k stars: 8 points the same bits alone, "
          f"in a bucket of 8 and at {placed} positions of buckets "
          f"{FITNESS_WIDTHS[0]}..{FITNESS_WIDTHS[-1]}; fitness "
          f"{base.numpy().round(5).tolist()}")


def _improving_commits(res) -> int:
    prev, n = np.asarray(res.server.specs[0].x0), 0
    for rec in res.server.engines[0].history:
        n += int(not np.array_equal(rec.center, prev))
        prev = rec.center
    return n


def phase_server(dev: torch.device):
    """The FGDO work server through its command line; returns the row-mean
    launches of the uninterrupted paper-scale run, those of the server
    substrate smokes' children, and that run's result doc and wall."""
    flags = SERVER_FLAGS + ["--device", str(dev)]
    _zero_counts()                  # this slice's path, counted from 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, res, doc = sim.run_cli(flags)
    wall = time.perf_counter() - t0
    counts = _counts()
    engine = res.server.engines[0]
    finishes = len(engine.phase_finish_s)
    pool = doc["pool"]
    improving = _improving_commits(res)
    print(f"[server] paper scale ({' '.join(SERVER_FLAGS[:8])}): "
          f"{doc['iteration']} iterations ({improving} improving), best "
          f"{doc['best_fitness']:.5f}, wall {wall:.1f}s (setup and warm "
          f"included), {pool['messages']} messages "
          f"({pool['messages'] / wall:.0f}/s), request_p99_ms "
          f"{doc['request_p99_ms']:.3f}, {pool['evals']} evals in "
          f"{pool['eval_batches']} batches, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
          f"{finishes} regression finishes, launches {counts}")
    check(improving >= 1, "the server run committed no improving iteration")
    check(counts["gram_launches"] == 2 * finishes > 0,
          f"gram launched {counts['gram_launches']} times for {finishes} "
          f"regression finishes (two fits each)")
    check(counts["row_mean_launches"] > 0, "the server run never launched "
          "the row_mean kernel")
    row_mean_launches = counts["row_mean_launches"]

    # the server and chaos_server substrate smokes: every leg a child
    # process on this card (the paper-scale run's buffers released first)
    del res
    reports = _server_runners(dev, "server",
                              server=dryrun.run_server_smoke,
                              chaos_server=dryrun.run_chaos_server_smoke)
    children = sum(sum(r["children"]["row_mean_launches"])
                   for r in reports.values())
    report = reports["server"]
    for leg, k in report["kill_restore"].items():
        print(f"[server] server smoke {leg}: SIGKILLed mid-run "
              f"{k['killed_mid_run']}, restored after replaying "
              f"{k['replayed']} records, re-leased {k['resumed_leases']}, "
              f"== the baseline {k['trajectory_equal']}"
              + (f", cache hits {k['cache']['hits']} (store "
                 f"{k['cache']['store_size']}), warm {k['warm_after_restore']}"
                 if "cache" in k else ""))
    check(report["backend_parity_ok"] and report["production_mesh_parity_ok"],
          "the server smoke's pod or 16 x 16 run differs from its baseline")
    report = reports["chaos_server"]
    plans = report["fault_plans"]
    print(f"[server] chaos_server smoke: concurrent clean parked "
          f"{report['concurrent_clean']['intake']['parked']}; "
          + "; ".join(f"{name} {p['faults_injected']} faults, "
                      f"{p['chaos']['retries']} retries, == the baseline "
                      f"{p['trajectory_equal']}"
                      for name, p in plans.items())
          + f"; pod {report['production_mesh_chaos']['mesh']} under "
          f"drop_dup == the baseline "
          f"{report['production_mesh_chaos']['trajectory_equal']}")
    return row_mean_launches, children, doc, wall


def _server_runners(dev: torch.device, tag: str, **runners) -> dict:
    """launch/dryrun.py's server substrate smokes ``runners`` (name →
    runner) on ``dev``, at once (a runner's thread mostly waits on its
    children), from zeroed launch counts and a reset memory peak: each
    one True, its children's devices and row_mean launches, its kill legs
    and walls printed under ``[tag]`` and checked; returns the reports by
    name."""
    _free()           # the children's CUDA contexts need the card's room
    free, total = torch.cuda.mem_get_info(dev)
    print(f"[{tag}] before the children: {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB free on the card, this process holding "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_substrate_") as out:
        legs = {name: (lambda r=runner: r(out, device=dev))
                for name, runner in runners.items()}
        oks, wall, counts, peak = _leg(
            dev, lambda: dryrun.ServerChildren.parallel(legs))
        reports = {}
        for name in runners:
            with open(os.path.join(out, f"substrate_{name}.json")) as f:
                reports[name] = json.load(f)
    for name, report in reports.items():
        check(oks[name] and report["parity_ok"],
              f"the {name} substrate smoke failed")
        kids = report["children"]
        if name == "server":
            kills = list(report["kill_restore"].values())
        else:
            kills = [report.get("kill_restore") or report["flight_recorder"]]
        print(f"[{tag}] {name} substrate smoke ({report['n_hosts']} hosts, "
              f"m = {report['m']}, {report['iterations']} iterations): "
              f"baseline {report['baseline']['iterations']} iterations, "
              f"best {report['baseline']['best']:.6f}, "
              f"{report['baseline']['messages']} messages; "
              f"{kids['children']} children on {kids['devices']}, row_mean "
              f"launches {kids['row_mean_launches']}; {len(kills)} "
              f"SIGKILLed mid-run and restored; child walls "
              + ", ".join(f"{leg} {t:.1f}s"
                          for leg, t in report["wall_s"].items()))
        check(kids["ok"] and kids["devices"] == [str(dev)]
              and all(n > 0 for n in kids["row_mean_launches"]),
              f"a {name} child did not run on {dev} or missed row_mean")
        check(all(k["killed_mid_run"] and not k.get("recovered_done")
                  and k["trajectory_equal"] for k in kills),
              f"a {name} kill leg was not killed mid-run or not restored "
              f"equal")
    print(f"[{tag}] {' and '.join(runners)} substrate smokes at once: wall "
          f"{wall:.1f}s, peak device memory {peak:.2f} GiB, in this "
          f"process {_gram_row_mean(counts)}")
    return reports


def _same_run(a: dict, b: dict) -> bool:
    """The reference smokes' parity gate (dryrun.py's
    ``trajectories_equal``)."""
    return all(a[k] == b[k] for k in ("history", "iteration", "best_fitness",
                                      "engine_stats"))


def phase_obs(dev: torch.device, base: dict, base_wall: float) -> int:
    """The observability plane on the work server: at paper scale beside
    ``[server]``'s uninterrupted run (``base``), then the obs_server and
    postmortem substrate smokes, the flight recorder's SIGKILL and
    restore among them; returns the row-mean launches of the smokes'
    children."""
    flags = SERVER_FLAGS + ["--device", str(dev)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        # (a) the whole plane on, at paper scale
        _zero_counts()
        ret = os.path.join(tmp, "a")
        t0 = time.perf_counter()
        _, res, doc = sim.run_cli(flags + ["--obs", "--subscribe",
                                           "--trace-rate", "1.0", "--retain",
                                           "--retain-dir", ret])
        wall = time.perf_counter() - t0
        counts = _counts()
        finishes = len(res.server.engines[0].phase_finish_s)
        sub, kept, trace = doc["subscriber"], doc["retention"], doc["trace"]
        same = _same_run(doc, base)
        print(f"[obs] (a) paper scale, hub + subscriber + trace 1.0 + "
              f"retention: {doc['obs']['snapshots']} snapshots (ring "
              f"{doc['obs']['ring']}), subscriber received {sub['snapshots']}"
              f" (seqs {sub['first_seq']}..{sub['last_seq']}, stamped and "
              f"increasing: {sub['stamped_ok']}, dropped {sub['dropped']}, "
              f"errors {len(sub['errors'])}), spans {trace['completed']} of "
              f"{trace['sampled']} traced (ring dropped "
              f"{trace['ring_dropped']}), retained {kept['snapshots_stored']}"
              f" snapshots + {kept['spans_stored']} spans, store "
              f"{os.path.getsize(obs_store_path(ret))} bytes; wall "
              f"{wall:.1f}s, {doc['pool']['messages']} messages "
              f"({doc['pool']['messages'] / wall:.0f}/s), observed / "
              f"unobserved wall {wall / base_wall:.3f}; launches {counts} "
              f"for {finishes} regression finishes; == [server]'s "
              f"uninterrupted run: {same}")
        check(same, "the observed paper-scale server run differs from the "
              "unobserved one")
        check(doc["obs"]["snapshots"] >= 2, "the hub took fewer than 2 "
              "snapshots at paper scale")
        check(sub["snapshots"] >= 2 and sub["stamped_ok"]
              and not sub["errors"], "the subscriber received fewer than 2 "
              "stamped snapshots in increasing seqs, or erred")
        check(counts["gram_launches"] == 2 * finishes > 0,
              f"gram launched {counts['gram_launches']} times for "
              f"{finishes} regression finishes of the observed run")

    # the obs_server and postmortem substrate smokes: every leg a child
    # process on this card (the paper-scale run's buffers released first)
    del res
    reports = _server_runners(dev, "obs",
                              obs_server=dryrun.run_obs_server_smoke,
                              postmortem=dryrun.run_postmortem_smoke)
    children = sum(sum(r["children"]["row_mean_launches"])
                   for r in reports.values())
    report = reports["obs_server"]
    live, d = report["observed_live"], report["defense"]
    sub = live["subscriber"]
    print(f"[obs] obs_server smoke: observed live {live['hub_snapshots']} "
          f"snapshots, subscriber received {sub['snapshots']} (stamped and "
          f"increasing {sub['stamped_ok']}, errors {len(sub['errors'])}); "
          f"under drop_dup {report['observed_chaos']['faults_injected']} "
          f"faults; restored after a SIGKILL with "
          f"{report['kill_restore']['hub_snapshots']} hub snapshots; "
          f"defense {d['events']} events {d['by_action']}, reliable set "
          f"{d['reliable_set_defended']} against "
          f"{d['reliable_set_undefended']} undefended, replay == live "
          f"{d['replay_trajectory_equal']}")
    report = reports["postmortem"]
    rec, stall = report["flight_recorder"], report["stall_kill"]
    print(f"[obs] postmortem smoke: replay logs "
          f"{report['replay_log_byte_compat']['bytes']} bytes, identical "
          f"with retention and tracing on and off "
          f"{report['replay_log_byte_compat']['identical']}; the dead "
          f"store read as epochs {rec['dead_epochs']} ("
          f"{rec['dead_snapshots']} snapshots, {rec['dead_spans']} spans, "
          f"{rec['dead_phase_transitions']} phase transitions, "
          f"{rec['replay_log_records']} log records), after the restore "
          f"{rec['post_restore_epochs']}; stall window killed "
          f"{stall['searches_killed']} at iteration "
          f"{stall['defended_iteration']} of "
          f"{stall['baseline_iteration']}, replay == live "
          f"{stall['replay_trajectory_equal']}")
    return children


#: [examples]: each example launcher (``launch/<name>.py``) and the flags
#: of its command line beside ``--device`` and ``--out``, at its example's
#: size, the longest first; the launchers whose every act evaluates the
#: SDSS fitness; and how many children run at once
EXAMPLES = (("volunteer_grid", []), ("train_lm", ["--fast"]),
            ("fgdo_service", []), ("multi_search", []),
            ("observability", []), ("quickstart", []), ("serve_lm", []))
EXAMPLES_SDSS = ("volunteer_grid", "fgdo_service", "multi_search",
                 "observability")
EXAMPLES_AT_ONCE = 2


def _example_children(dev: torch.device, tmp: str) -> dict:
    """Every example launcher as a child forked from the forkserver on
    ``dev``, ``EXAMPLES_AT_ONCE`` at a time, each writing its doc to
    ``<name>.json`` and its output to ``<name>.out`` / ``.err``; returns
    {name: (exit code, wall s)}."""
    from multiprocessing.connection import wait

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    queue, running, done = list(EXAMPLES), {}, {}
    while queue or running:
        while queue and len(running) < EXAMPLES_AT_ONCE:
            name, flags = queue.pop(0)
            extra = (["--ckpt-dir", os.path.join(tmp, "train_ckpt")]
                     if name == "train_lm" else [])
            argv = [*flags, *extra, "--device", str(dev),
                    "--out", os.path.join(tmp, f"{name}.json")]
            proc = child.start(f"repro_torch.launch.{name}", argv, env,
                               os.path.join(tmp, f"{name}.out"),
                               os.path.join(tmp, f"{name}.err"), name=name)
            running[proc.sentinel] = (name, proc, time.perf_counter())
        for sentinel in wait(list(running), timeout=600):
            name, proc, t0 = running.pop(sentinel)
            proc.join()
            done[name] = (proc.exitcode, time.perf_counter() - t0)
        for sentinel, (name, proc, t0) in list(running.items()):
            if time.perf_counter() - t0 > 600:       # hung: end it
                proc.kill()
                proc.join()
                running.pop(sentinel)
                done[name] = (proc.exitcode, time.perf_counter() - t0)
    return done


def _act_summary(name: str, act: str, rec: dict) -> str:
    n = rec["launches"]
    best = (f", best {rec['best_fitness']:.5f}"
            if rec.get("best_fitness") is not None else "")
    its = (f" {rec['iterations']} iterations" if "iterations" in rec
           else "")
    evals = (f", {rec['evaluations']} evaluations"
             if "evaluations" in rec else "")
    return (f"{act}{its}{best}{evals}, row_mean {n['row_mean_launches']}, "
            f"gram {n['gram_launches']}, {rec['wall_s']:.1f}s")


def phase_examples(dev: torch.device) -> int:
    """The example launchers on the card, each through its command line
    as a child process: exit 0 on ``dev`` with every gate of its doc
    true, row_mean launched in every act that evaluates the SDSS fitness,
    and gram launched as ``fit_quadratic`` routes it (m·cols under
    ``GRAM_KERNEL_MIN_ELEMENTS``: never).  Returns the children's
    row_mean launches."""
    _free()           # the children's CUDA contexts need the card's room
    free, total = torch.cuda.mem_get_info(dev)
    print(f"[examples] before the children: {free / 2**30:.2f} of "
          f"{total / 2**30:.2f} GiB free on the card, this process holding "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB")
    row_means = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        done = _example_children(dev, tmp)
        wall = time.perf_counter() - t0
        for name, _ in EXAMPLES:
            rc, child_wall = done[name]
            if rc != 0:
                for ext in ("out", "err"):
                    with open(os.path.join(tmp, f"{name}.{ext}")) as f:
                        print(f"[examples] {name} std{ext} (end):\n"
                              f"{f.read()[-3000:]}")
            check(rc == 0, f"the {name} launcher exited {rc}")
            with open(os.path.join(tmp, f"{name}.json")) as f:
                doc = json.load(f)
            acts = doc["acts"]
            print(f"[examples] {name} on {doc['device']} (child "
                  f"{child_wall:.1f}s): "
                  + "; ".join(_act_summary(name, a, r)
                              for a, r in acts.items()))
            failed = [f"{a}: {g}" for a, r in acts.items()
                      for g, held in r["gates"].items() if not held]
            check(doc["device"] == str(dev) and doc["ok"] and not failed,
                  f"{name}: device {doc['device']}, failed gates {failed}")
            for act, rec in acts.items():
                n = rec["launches"]
                routed = rec.get("fit_elements", 0) >= \
                    GRAM_KERNEL_MIN_ELEMENTS
                check((n["gram_launches"] > 0) == routed,
                      f"{name} {act}: gram launched {n['gram_launches']} "
                      f"times for fits of {rec.get('fit_elements')} "
                      f"elements")
                if name in EXAMPLES_SDSS:
                    check(n["row_mean_launches"] > 0
                          and rec["evaluations"] > 0,
                          f"{name} {act} missed row_mean: {n}")
                row_means += n["row_mean_launches"]
    print(f"[examples] {len(EXAMPLES)} launchers, {EXAMPLES_AT_ONCE} at "
          f"once: wall {wall:.1f}s, row_mean launches {row_means}")
    return row_means


def _substrate_smoke(dev: torch.device, runner, name: str, **kw):
    """Run ``dryrun.<runner>`` on ``dev`` into a temporary directory from
    zeroed launch counts; returns (its report, wall s, peak GiB).  Its
    result must be True and its report must say so."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_substrate_") as out:
        ok, wall, _, peak = _leg(dev, lambda: runner(out, device=dev, **kw))
        with open(os.path.join(out, f"substrate_{name}.json")) as f:
            report = json.load(f)
    check(ok and report["parity_ok"], f"the {name} substrate smoke failed")
    return report, wall, peak


def _check_sdss_leg(name: str, launches: dict) -> None:
    check(launches.get("gram_launches", 0) > 0
          and launches.get("row_mean_launches", 0) > 0,
          f"{name} missed the gram or row_mean kernel: {launches}")


def _gram_row_mean(launches: dict) -> str:
    return (f"gram {launches.get('gram_launches', 0)}, row_mean "
            f"{launches.get('row_mean_launches', 0)}")


def phase_portfolio(dev: torch.device) -> None:
    """``launch/dryrun.py``'s multi_search substrate smoke at paper scale:
    a heterogeneous portfolio coalesced over the in-process backend and
    over the pod backend on the virtual 16 × 16 mesh, every search ==
    its solo run on both, the backends equal search by search."""
    report, wall, peak = _substrate_smoke(
        dev, dryrun.run_multi_search_smoke, "multi_search",
        **SUBSTRATE_PORTFOLIO)
    for name, b in report["backends"].items():
        print(f"[portfolio] {name}: {report['n_searches']} searches (m = "
              f"{report['m']} / {report['m'] // 2}, {b['iterations']} "
              f"iterations) on {report['fleet_hosts']} hosts at "
              f"{report['n_stars']} stars: {b['rounds']} rounds, "
              f"{b['dispatches']} dispatches for {b['lane_blocks']} blocks, "
              f"padded lanes {b['padded_lanes']} vs "
              f"{b['solo_padded_lanes']} solo; coalesced + solo re-runs "
              f"{b['wall_s']}s; == solo: {b['parity_per_search']}; best "
              f"{min(b['final']):.5f}; {_gram_row_mean(b['launches'])}")
        _check_sdss_leg(f"the {name} portfolio", b["launches"])
        check(b["dispatches"] < b["lane_blocks"],
              f"coalescing saved no dispatch on {name}")
        check(all(i == SUBSTRATE_PORTFOLIO["iterations"]
                  for i in b["iterations"]),
              f"a {name} portfolio search stopped early")
    check(report["cross_backend_stats_equal"],
          "the backends' portfolios ended with different engine stats")
    print(f"[portfolio] multi_search substrate smoke on {report['mesh']}: "
          f"in-process == pod search by search, iterates "
          f"{report['cross_backend_ok']} and engine stats "
          f"{report['cross_backend_stats_equal']}; wall {wall:.1f}s, peak "
          f"device memory {peak:.2f} GiB")


def _virtual_pod(dev: torch.device):
    """The production 16 × 16 mesh over 256 virtual devices that are all
    ``dev``."""
    return make_production_mesh(devices=virtual_devices(256, dev))


def _leg(dev: torch.device, fn):
    """Run one leg from zeroed launch counts and a reset memory peak;
    returns (its result, wall seconds, its counts, peak GiB)."""
    _zero_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    return out, wall, _counts(), peak


def _ranks_leg(tag: str, report: dict, devices: list) -> dict:
    """Gate and print a pod_mesh smoke's leg over ranks: every rank
    exited 0 on its device in ``devices`` and committed the pod leg's
    iterates and engine stats, with no bucket shape first run after warm;
    the ranks' row_mean launches sum to the pod leg's (each evaluates its
    own row blocks) and each rank's gram launches equal it (each runs the
    engine).  Returns the ranks' summed launches."""
    per = report["per_rank"]
    check(report["ranks_parity_ok"], f"{tag}: over {report['ranks']} "
          f"{report['dist_backend']} ranks: "
          f"{report['ranks_failed'] or 'a rank left the pod leg'}")
    one = report["launches"]["pod_mesh"]
    summed = {}
    for r, doc in enumerate(per):
        print(f"[pod] {tag} rank {r} of {report['ranks']} "
              f"({report['dist_backend']}) on {doc['device']}: "
              f"{doc['data_shards']} data shards, grid wall "
              f"{doc['wall_s']}s, peak device memory {doc['peak_gib']:.2f} "
              f"GiB, {_gram_row_mean(doc['launches'])}")
        check(doc["device"] == str(devices[r]),
              f"{tag}: rank {r} ran on {doc['device']}, not {devices[r]}")
        check(doc["new_shapes_after_warm"] == 0,
              f"{tag}: rank {r} first ran a bucket shape after warm")
        check(doc["launches"].get("gram_launches", 0)
              == one.get("gram_launches", 0),
              f"{tag}: rank {r}'s gram launches {doc['launches']} against "
              f"the pod leg's {one}")
        for key, n in doc["launches"].items():
            summed[key] = summed.get(key, 0) + n
    check(summed.get("row_mean_launches", 0)
          == one.get("row_mean_launches", 0) > 0,
          f"{tag}: the ranks' row_mean launches {summed} against the pod "
          f"leg's {one}")
    print(f"[pod] {tag} over {report['ranks']} {report['dist_backend']} "
          f"ranks: every rank == the one-process pod leg ({report['mesh']}), "
          f"iterates and engine stats, best "
          f"{report['final']['pod_mesh']:.5f}; "
          f"row_mean summed {summed.get('row_mean_launches', 0)} == the pod "
          f"leg's; wall {report['ranks_wall_s']}s (forks, each rank's "
          f"problem, warm and grid)")
    return summed


def phase_pod(dev: torch.device) -> dict:
    """The pod-mesh evaluation backend on the main path: (a) the
    paper-scale grid, with (a2) its pod leg over gloo ranks sharing this
    card, (a3) a one-rank NCCL group at smoke size, (b) the work server
    at smoke size (then a crash/restore), (c) the portfolio and the eval
    cache, on the (1, 1) mesh of this card and the virtual 16 × 16 mesh.
    Returns the launches of the legs over ranks, summed over the
    ranks."""
    # (a) the batched grid at paper scale: the pod_mesh substrate smoke on
    # the virtual 16 x 16 mesh, with (a2) its pod leg over gloo ranks,
    # then on this card's (1, 1) mesh
    finals = set()
    ranks_launches = {}
    for mesh, over in ((None, POD_RANKS),
                       (Mesh((1, 1), ("data", "model"), [dev]), 0)):
        report, wall, peak = _substrate_smoke(
            dev, dryrun.run_substrate_smoke, "pod_mesh", mesh=mesh,
            ranks=over, dist_backend="gloo", **SUBSTRATE_GRID)
        tag = report["mesh"]
        for leg, launches in report["launches"].items():
            print(f"[pod] (a) {tag} grid {leg}: "
                  f"{report['iterations'][leg]} iterations, best "
                  f"{report['final'][leg]:.5f}, wall "
                  f"{report['wall_s'][leg]}s, {report['batch_calls'][leg]} "
                  f"buckets, {_gram_row_mean(launches)}")
            _check_sdss_leg(f"the {tag} {leg} grid", launches)
            check(report["iterations"][leg] == SUBSTRATE_GRID["iterations"],
                  f"the {tag} {leg} grid stopped early")
            finals.add(report["final"][leg])
        check(report["new_shapes_after_warm"] == 0,
              f"a bucket shape was first run after warm on {tag}")
        check(all(report["stats_equal"].values()),
              f"a {tag} grid leg's engine stats differ from the sync leg's: "
              f"{report['stats_equal']}")
        ranks_wall = report.get("ranks_wall_s", 0)
        print(f"[pod] (a) pod_mesh substrate smoke ({report['n_stars']} "
              f"stars, {report['n_hosts']} hosts, m = {report['m']}) on "
              f"{tag} ({report['data_shards']} data shard(s), floor "
              f"{report['min_bucket']}): in-process sync == in-process "
              f"pipelined == pod pipelined, iterates and engine stats, no "
              f"bucket shape first run after warm; wall "
              f"{wall - ranks_wall:.1f}s (warm included; (a2) not), peak "
              f"device memory {peak:.2f} GiB")
        if over:
            ranks_launches = _ranks_leg("(a2)", report, [dev] * over)
    check(len(finals) == 1, f"the 16x16 and (1, 1) runs ended apart: "
          f"{sorted(finals)}")

    # (a3) a one-rank NCCL group at (b)'s smoke size, the backend chosen
    # and printed plainly; two NCCL ranks where there are two cards
    for world in [1] + ([2] if torch.cuda.device_count() >= 2 else []):
        devices = [torch.device("cuda", r) for r in range(world)]
        report, wall, peak = _substrate_smoke(
            dev, dryrun.run_substrate_smoke, "pod_mesh", ranks=world,
            dist_backend="nccl", **SUBSTRATE_NCCL)
        print(f"[pod] (a3) pod_mesh substrate smoke ({report['n_stars']} "
              f"stars, {report['n_hosts']} hosts, m = {report['m']}) on "
              f"{report['mesh']} over {world} rank(s), backend "
              f"{report['dist_backend']} on {[str(d) for d in devices]}: "
              f"one-process legs == each other; wall {wall:.1f}s, of it "
              f"the ranks {report['ranks_wall_s']}s")
        for key, n in _ranks_leg("(a3)", report, devices).items():
            ranks_launches[key] = ranks_launches.get(key, 0) + n

    # (b) the work server through --backend pod_mesh, at the smoke size
    # (the paper-scale re-run of [server]'s run was cut for the
    # smoke's time: [server] and [obs] (a) run that size)
    flags = ["--device", str(dev)]
    _, _, loop = sim.run_cli(flags)
    (_, res, doc), wall, counts, peak = _leg(
        dev, lambda: sim.run_cli(flags + ["--backend", "pod_mesh"]))
    same = _same_run(doc, loop)
    print(f"[pod] (b) server at the smoke size, --backend pod_mesh (1 data "
          f"shard): {doc['iteration']} iterations, best "
          f"{doc['best_fitness']:.6f}, {doc['pool']['messages']} messages, "
          f"wall {wall:.1f}s, peak device memory {peak:.2f} GiB, gram "
          f"{counts['gram_launches']}, row_mean "
          f"{counts['row_mean_launches']}; == in-process: {same}")
    check(same, "the pod_mesh server run differs from the in-process one")
    check(counts["row_mean_launches"] > 0,
          "the pod_mesh server missed the row_mean kernel")

    # ... and the crash/restore contract on the virtual 16 × 16 backend
    spec, fleet, f_small = sim.smoke_problem(device=dev)
    base = sim.result_doc(sim.ServerSubstrate(
        spec, fleet, InProcessEvalBackend(f_small, device=dev)).run())
    pod = PodMeshEvalBackend(f_small, mesh=_virtual_pod(dev), device=dev)

    def crash_restore():
        whole = sim.result_doc(sim.ServerSubstrate(spec, fleet, pod).run())
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pod_") as ckpt:
            try:
                sim.ServerSubstrate(
                    spec, fleet, pod, ckpt_dir=ckpt, snapshot_every=25,
                    max_messages=int(0.4 * base["pool"]["messages"])).run()
                check(False, "the pod server finished before its crash point")
            except sim.SimulatedCrash as e:
                crash = str(e)
            back = sim.result_doc(sim.ServerSubstrate(
                spec, fleet, pod, ckpt_dir=ckpt,
                snapshot_every=25).run(resume=True))
        return whole, back, crash
    (whole, back, crash), wall, counts, peak = _leg(dev, crash_restore)
    ok = all(_same_run(d, base) for d in (whole, back))
    print(f"[pod] (b) smoke size (400 stars, 192 hosts, m = 24) on pod "
          f"16x16 ({pod.n_shards} data shards, floor {pod.min_bucket}): "
          f"{crash}; restored after {back['replayed']} records; restored "
          f"== uninterrupted == in-process: {ok}; wall {wall:.1f}s, peak "
          f"device memory {peak:.2f} GiB, gram {counts['gram_launches']}, "
          f"row_mean {counts['row_mean_launches']}")
    check(ok, "the pod 16x16 server's restored or uninterrupted run "
          "differs from the in-process run")
    del pod, f_small

    # (c) the eval cache under the portfolio: the cached_portfolio smoke
    report, wall, peak = _substrate_smoke(
        dev, dryrun.run_cached_portfolio_smoke, "cached_portfolio",
        **SUBSTRATE_CACHED)
    for name, b in report["backends"].items():
        st = b["cache"]
        print(f"[pod] (c) eval cache, {name}: {report['n_searches']} "
              f"searches, off / cold / warm {b['wall_s']['off']}s / "
              f"{b['wall_s']['cold']}s / {b['wall_s']['warm']}s, hits "
              f"{st['hits']}, misses {st['misses']}, full buckets "
              f"{st['full_buckets']}; cold == warm == cache off: "
              f"{b['cold_parity'] and b['warm_parity']}, warm fully "
              f"served: {b['warm_fully_served']}; " + "; ".join(
                  f"{run} {_gram_row_mean(n)}"
                  for run, n in b["launches"].items()))
        for run, launches in b["launches"].items():
            _check_sdss_leg(f"the {name} {run} cached portfolio", launches)
    print(f"[pod] (c) cached_portfolio substrate smoke on {report['mesh']}: "
          f"wall {wall:.1f}s, peak device memory {peak:.2f} GiB")
    return ranks_launches


def phase_pod_lm(dev: torch.device, arch: str, lm: dict) -> int:
    """Danube: act 1 over its loss on the LM backend's mesh route over the
    virtual 16 × 16 mesh, reusing ``[lm]``'s workload and engines.
    rwkv6: ``launch/dryrun.py``'s lm_subspace substrate smoke on ``[lm]``'s
    workload (acts 1 to 3 of the reference's runner), then, the workload
    freed, act 1 over ranks (``_pod_lm_ranks``), and the model axis over
    ranks: (p1) ``_pod_lm_points`` and (p2) ``_pod_lm_grid``.  Frees the
    workload; returns the kernel launches of the ranks (0 for
    danube)."""
    if arch == "rwkv6-7b":
        _pod_lm_subspace(dev, lm)
    else:
        _pod_lm_act1(dev, arch, lm)
    sync, n_layers = lm["sync"], lm["n_layers"]
    torch.cuda.synchronize(dev)
    lm.clear()
    gc.collect()
    torch.cuda.empty_cache()
    if arch != "rwkv6-7b":
        return 0
    return (_pod_lm_ranks(dev, arch, sync, n_layers)
            + _pod_lm_points(dev, arch) + _pod_lm_grid(dev, arch))


def _rank_line(tag: str, r: int, doc: dict) -> str:
    return (f"[pod lm] {tag} rank {r} (data {doc['data_block']}, model "
            f"{doc['model_block']} of {doc['model_ranks']}) on "
            f"{doc['device']}: stores {doc['stored_bytes']:,} B")


def _pod_lm_points(dev: torch.device, arch: str) -> int:
    """(p1): ``[lm]``'s workload at published widths and k = 2 on the
    (1, 2) mesh over 2 gloo ranks sharing this card, the model axis cut
    over both (``dryrun.lm_points_rank``): each rank builds the whole
    chart from its seeds, keeps its model blocks, frees the rest, and
    scores given points in two buckets, all-gathering θ0's and the
    basis's cut leaves over the model group before each.  This process
    scores the same points in-process first.  Every rank's values equal
    this process's bit for bit; its stored bytes and each bucket's
    handed bytes and all-gathers equal ``lm_loss.reckon_model_ranks``;
    its chunked wkv6 launches equal its lanes × layers.  Returns the
    ranks' wkv6 launches, summed."""
    from repro_torch.core.substrates.lm_loss import (make_lm_workload,
                                                     reckon_model_ranks)
    counter = LM_KERNEL[arch][0]
    kw = dict(arch=arch, k=LM_P1["k"], seed=LM_WORKLOAD_SEED,
              full_width=True, n_layers=LM_DEPTH[arch], seq_len=LM_SEQ_LEN)
    n = sum(LM_P1["buckets"])
    pts = np.random.default_rng(35).uniform(-0.3, 0.3, (n, LM_P1["k"]))
    cut = np.cumsum((0,) + LM_P1["buckets"])
    buckets = [pts[a:b] for a, b in zip(cut[:-1], cut[1:])]
    t0 = time.perf_counter()
    wl = make_lm_workload(device=dev, **kw)
    cfg, n_layers = wl.cfg, wl.cfg.n_layers
    one = LmLossEvalBackend(wl)
    want = [one(b).tolist() for b in buckets]
    del wl, one
    _free()
    t_one = time.perf_counter() - t0
    grid = dryrun.rank_grid(LM_P1["ranks"], LM_P1["model_ranks"],
                            Mesh(LM_P1["mesh"], ("data", "model"),
                                 virtual_devices(2, dev)))
    reckoned = reckon_model_ranks(cfg, grid, LM_P1["k"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p1_") as workdir:
        res = ranks.run(
            "repro_torch.launch.dryrun:lm_points_rank",
            dict(kw, mesh_shape=LM_P1["mesh"], axis_names=["data", "model"],
                 model_ranks=LM_P1["model_ranks"],
                 buckets=[b.tolist() for b in buckets]),
            world=LM_P1["ranks"], backend="gloo",
            devices=[dev] * LM_P1["ranks"], workdir=workdir, timeout=400)
    check(res.returncode == 0, f"[pod lm] (p1): {res.failed}")
    print(f"[pod lm] (p1) {arch} at published widths, {n_layers} layer(s), "
          f"k = {LM_P1['k']} ({cfg.vocab_size} vocab): in-process "
          f"{n} points in {len(buckets)} buckets {t_one:.1f}s; reckoned a "
          f"rank: stores {reckoned['stored_bytes']:,} B, hands "
          f"{reckoned['gather_bytes']:,} B in {reckoned['gathers']} "
          f"all-gathers a bucket")
    total = 0
    for r, doc in enumerate(res.docs):
        check(doc["device"] == str(dev), f"(p1) rank {r} ran on "
              f"{doc['device']}")
        check(doc["chart_freed"] and doc["stored_bytes"]
              == reckoned["stored_bytes"], f"(p1) rank {r}: stores "
              f"{doc['stored_bytes']} B, chart freed {doc['chart_freed']}")
        for i, b in enumerate(doc["buckets"]):
            lanes = bucket_size(len(b["values"]))
            got = b["launches"]
            print(f"[pod lm] (p1) rank {r} bucket {i}: {b['gather_bytes']:,}"
                  f" B in {b['gathers']} all-gathers, {b['gather_s']}s of "
                  f"{b['wall_s']}s; {counter} {got.get(counter, 0)}")
            check(b["values"] == want[i], f"(p1) rank {r} bucket {i}: "
                  f"{b['values']} against in-process {want[i]}")
            check(b["gather_bytes"] == reckoned["gather_bytes"]
                  and b["gathers"] == reckoned["gathers"],
                  f"(p1) rank {r} bucket {i}: {b['gather_bytes']} B in "
                  f"{b['gathers']} all-gathers")
            check(got.get(counter, 0) == got.get("wkv6_launches", 0)
                  == lanes * n_layers, f"(p1) rank {r} bucket {i}: {got} "
                  f"for {lanes} lanes x {n_layers} layers")
            total += got.get("wkv6_launches", 0)
        print(_rank_line("(p1)", r, doc) + f", == in-process bit for bit, "
              f"chart freed; peak device memory {doc['peak_gib']:.2f} GiB")
    print(f"[pod lm] (p1) over {LM_P1['ranks']} gloo ranks: wall "
          f"{res.wall_s:.1f}s (forks, each rank's chart, 2 buckets)")
    return total


def _pod_lm_grid(dev: torch.device, arch: str) -> int:
    """(p2): act 1 on ``arch``'s smoke configuration (``sim.lm_problem``'s
    defaults) on the production 16 × 16 mesh over 4 gloo ranks sharing
    this card, the (2, 2) grid (``dryrun.lm_grid_rank``): every rank ==
    this process's in-process sync run, iterates and engine stats, its
    chart counts as reckoned (``dryrun.chart_counts``), half of the
    one-process 16 × 16 pod leg's lanes, its chunked wkv6 launches ==
    its lanes × layers, no bucket shape first run after warm.  Returns
    the ranks' wkv6 launches, summed."""
    counter = LM_KERNEL[arch][0]
    search, fleet, wl = sim.lm_problem(arch=arch, device=dev)
    m = search.anm.m_regression
    sync, _, _ = anm_lm.run(search, fleet, anm_lm.warmed_backend(wl, m),
                            pipelined=False)
    pod = anm_lm.warmed_backend(wl, m, mesh=_virtual_pod(dev))
    lanes0 = pod.lanes_evaluated
    on_pod, _, _ = anm_lm.run(search, fleet, pod)
    lanes = pod.lanes_evaluated - lanes0
    check(identical_trajectories(on_pod, sync) and on_pod.stats == sync.stats,
          "(p2): the one-process pod leg differs from the sync run")
    shape = LM_P2["mesh"]
    grid = dryrun.rank_grid(LM_P2["ranks"], LM_P2["model_ranks"],
                            _virtual_pod(dev))
    counts = dryrun.chart_counts(wl.cfg, grid, wl.k)
    n_layers = wl.cfg.n_layers
    del wl, pod
    _free()
    rep = dryrun.over_ranks(
        "repro_torch.launch.dryrun:lm_grid_rank",
        dict(arch=arch, mesh_shape=shape, axis_names=["data", "model"],
             model_ranks=LM_P2["model_ranks"]),
        LM_P2["ranks"], "gloo", dev, sync, counts=counts)
    check(rep["ranks_parity_ok"], f"(p2) {arch} over ranks: "
          f"{rep['ranks_failed'] or 'a rank left the sync run or its counts'}")
    total = 0
    for r, doc in enumerate(rep["per_rank"]):
        n = doc["launches"]
        print(_rank_line("(p2)", r, doc) + f"; {doc['gathered_buckets']} "
              f"buckets, {doc['model_gather_bytes']:,} B in "
              f"{doc['model_gathers']} all-gathers ({doc['model_gather_s']}"
              f"s), {doc['lanes']} lanes, {counter} {n.get(counter, 0)}")
        check(doc["device"] == str(dev), f"(p2) rank {r} on {doc['device']}")
        check(doc["lanes"] * 2 == lanes, f"(p2) rank {r}: {doc['lanes']} "
              f"lanes, the one-process pod leg {lanes}")
        check(n.get(counter, 0) == n.get("wkv6_launches", 0)
              == doc["lanes"] * n_layers > 0,
              f"(p2) rank {r}: {n} for {doc['lanes']} lanes x {n_layers}")
        check(doc["new_shapes_after_warm"] == 0,
              f"(p2) rank {r} first ran a bucket shape after warm")
        total += n.get("wkv6_launches", 0)
    print(f"[pod lm] (p2) {arch} smoke act 1 over {LM_P2['ranks']} gloo "
          f"ranks, {shape[0]}x{shape[1]} in a (2, 2) grid: every rank == "
          f"the sync run ({sync.iteration} iterations, best "
          f"{sync.best_fitness:.6f}) and its reckoned counts, half of the "
          f"pod leg's {lanes} lanes; wall {rep['ranks_wall_s']}s")
    return total


def _pod_lm_ranks(dev: torch.device, arch: str, sync, n_layers: int) -> int:
    """Act 1 at ``[lm]``'s one iteration over ``LM_RANKS`` gloo ranks
    sharing this card, the LM backend's mesh route on the (2, 1) mesh over
    them (``dryrun.lm_grid_rank``: each rank builds ``[lm]``'s workload
    from its seeds, scores its half of every bucket's lanes and
    all-gathers the rest): every rank on this card and == ``[lm]``'s
    in-process sync run, iterates and engine stats; each rank's chunked
    wkv6 launches == its lanes × layers.  Returns the ranks' wkv6
    launches, summed."""
    counter = LM_KERNEL[arch][0]
    rep = dryrun.over_ranks(
        "repro_torch.launch.dryrun:lm_grid_rank",
        dict(lm_problem_kw(arch), mesh_shape=LM_RANKS_MESH,
             axis_names=["data", "model"]),
        LM_RANKS, "gloo", dev, sync)
    check(rep["ranks_parity_ok"], f"[pod lm] {arch} over ranks: "
          f"{rep['ranks_failed'] or 'a rank left [lm] act 1 sync run'}")
    total = 0
    for r, doc in enumerate(rep["per_rank"]):
        n = doc["launches"]
        print(f"[pod lm] {arch} act 1 rank {r} of {LM_RANKS} (gloo) on "
              f"{doc['device']}: {doc['data_shards']} data shard, "
              f"{doc['lanes']} lanes, grid wall {doc['wall_s']}s, peak "
              f"device memory {doc['peak_gib']:.2f} GiB, launches {n}")
        check(doc["device"] == str(dev),
              f"[pod lm] rank {r} ran on {doc['device']}")
        check(doc["n_layers"] == n_layers and n.get(counter, 0)
              == n.get("wkv6_launches", 0) == doc["lanes"] * n_layers > 0,
              f"[pod lm] rank {r}: {n} for {doc['lanes']} lanes x "
              f"{n_layers} layers")
        check(doc["new_shapes_after_warm"] == 0,
              f"[pod lm] rank {r} first ran a bucket shape after warm")
        total += n.get("wkv6_launches", 0)
    print(f"[pod lm] {arch} act 1 over {LM_RANKS} gloo ranks on the "
          f"{LM_RANKS_MESH[0]}x{LM_RANKS_MESH[1]} mesh: every rank == [lm]'s "
          f"sync run ({sync.iteration} iterations, best "
          f"{sync.best_fitness:.6f}), iterates and engine stats; wall "
          f"{rep['ranks_wall_s']}s (forks, each rank's workload, warm and "
          f"act 1)")
    return total


def _pod_lm_act1(dev: torch.device, arch: str, lm: dict) -> None:
    counter = LM_KERNEL[arch][0]
    search, fleet, wl = lm["search"], lm["fleet"], lm["wl"]
    n_layers = lm["n_layers"]
    t0 = time.perf_counter()
    pod = anm_lm.warmed_backend(wl, search.anm.m_regression,
                                mesh=_virtual_pod(dev))
    torch.cuda.synchronize(dev)
    cut, total = pod.sharded_params
    print(f"[pod lm] {arch}: {pod.n_shards} data shards (floor "
          f"{pod.min_bucket}), spec_fallbacks {pod.spec_fallbacks}, "
          f"{cut} of {total} parameters ({100 * cut / total:.1f} %) stored "
          f"cut 16 ways over model; warmed {pod.compile_count} bucket "
          f"shapes in {time.perf_counter() - t0:.1f}s")
    shapes = pod.compile_count
    lanes0 = pod.lanes_evaluated
    out, wall, counts, peak = _leg(
        dev, lambda: anm_lm.run(search, fleet, pod)[0])
    lanes = pod.lanes_evaluated - lanes0
    launches = counts[counter]
    ok = (identical_trajectories(out, lm["sync"])
          and identical_trajectories(out, lm["pipe"])
          and out.stats == lm["sync"].stats)
    print(f"[pod lm] {arch} act 1 pipelined on pod 16x16: {out.iteration} "
          f"iterations, best {out.best_fitness:.6f}; == in-process sync == "
          f"in-process pipelined: {ok}; wall {wall:.1f}s, {lanes} lanes, "
          f"{counter} {launches}, peak device memory {peak:.2f} GiB, all "
          f"counts {counts}")
    check(ok, f"{arch} act 1: the pod run differs from in-process")
    check(launches == lanes * n_layers > 0, f"{arch} act 1: {launches} "
          f"kernel launches for {lanes} lanes x {n_layers} layers")
    check(counts["flash_attention_launches"]
          == counts["flash_attention_wgmma_launches"]
          and counts["wkv6_launches"] == counts["wkv6_chunked_launches"],
          f"{arch} act 1: a launch left the main path's variant")
    check(pod.compile_count == shapes,
          f"{arch}: a bucket shape was first run after warm on pod 16x16")


def _pod_lm_subspace(dev: torch.device, lm: dict) -> None:
    """The lm_subspace substrate smoke over rwkv6 at published widths
    (``[lm]``'s workload; the grid and the server at act 1's iterations,
    the portfolio at act 2's): every gate's engine stats equal, the sync
    leg == ``[lm]``'s act-1 sync run, and each gate's wkv6 launches one a
    layer a lane evaluated, all chunked."""
    search, n_layers, sync = lm["search"], lm["n_layers"], lm["sync"]
    report, wall, peak = _substrate_smoke(
        dev, dryrun.run_lm_subspace_smoke, "lm_subspace",
        problem=(search, lm["fleet"], lm["wl"]),
        portfolio_iterations=LM_ACT2_ITERATIONS)
    g, o, sv = report["grid"], report["orchestrator"], report["server"]
    print(f"[pod lm] rwkv6-7b lm_subspace substrate smoke on "
          f"{report['mesh']} ({report['data_shards']} data shards, floor "
          f"{report['min_bucket']}, spec_fallbacks "
          f"{report['model_spec_fallbacks']}), P = {report['n_params']}, "
          f"{report['iterations']} iterations (portfolio "
          f"{o['iterations']}): warm {report['warm_s']}s; "
          f"grid sync / pipelined / pod {g['wall_s']['sync']}s / "
          f"{g['wall_s']['pipelined']}s / {g['wall_s']['pod']}s, best "
          f"{g['final']['sync']:.6f}, == : {g['pipelined_parity_ok']} / "
          f"{g['pod_parity_ok']}, new shapes after warm: "
          f"{not report['compiles']['zero_after_warm']}; portfolio of 2 "
          f"through the cache {o['wall_s']}s, == solo "
          f"{o['solo_parity']}, warm fully served "
          f"{o['warm_fully_served']} (hits {o['cache']['hits']}); server "
          f"{sv['messages']} messages, in-process == pod "
          f"{sv['backend_parity_ok']}, crashed and restored after "
          f"{sv['replayed']} records == uninterrupted "
          f"{sv['restore_parity_ok']}, {sv['wall_s']}s; wall {wall:.1f}s, "
          f"peak device memory {peak:.2f} GiB")
    check(report["n_layers"] == n_layers
          and report["iterations"] == search.anm.max_iterations
          and o["iterations"] == LM_ACT2_ITERATIONS,
          "the lm_subspace smoke ran another workload than [lm]'s")
    check(g["iterations"]["sync"] == sync.iteration
          and g["final"]["sync"] == sync.best_fitness,
          f"the lm_subspace sync leg ({g['iterations']['sync']} iterations, "
          f"best {g['final']['sync']}) differs from [lm]'s act 1 "
          f"({sync.iteration}, {sync.best_fitness})")
    check(all(g["stats_equal"].values()) and all(o["solo_stats_equal"])
          and o["warm_stats_equal"],
          f"lm_subspace: engine stats differ: grid {g['stats_equal']}, "
          f"solo {o['solo_stats_equal']}, warm {o['warm_stats_equal']}")
    print(f"[pod lm] rwkv6-7b lm_subspace: sync leg == [lm]'s act-1 sync "
          f"run; engine stats equal: grid {g['stats_equal']}, solo "
          f"{o['solo_stats_equal']}, warm replay {o['warm_stats_equal']}")
    for name, k in report["kernels"].items():
        n = k["launches"]
        print(f"[pod lm] rwkv6-7b lm_subspace {name}: {k['lanes']} lanes, "
              f"launches {n}")
        check(n.get("wkv6_launches", 0) == k["lanes"] * n_layers > 0,
              f"lm_subspace {name}: {n} for {k['lanes']} lanes x "
              f"{n_layers} layers")
        check(n.get("wkv6_chunked_launches", 0) == n.get("wkv6_launches")
              and not n.get("flash_attention_launches"),
              f"lm_subspace {name}: a launch left the chunked wkv6 kernel")


def _subspace_step(dev, loss, params, state, gen):
    """One subspace-Newton step drawn from ``gen``; returns (new params,
    new state, info as floats, wall s, counts, peak GiB)."""
    (new, state, info), wall, counts, peak = _leg(
        dev, lambda: subspace_newton_step(loss, params, state, SUBSPACE_CFG,
                                          gen, device=dev))
    return (new, state, {k: float(v) for k, v in info.items()}, wall, counts,
            peak)


def _route_gap(kernel: torch.Tensor, plain: torch.Tensor) -> float:
    """Largest |kernel − plain| / |plain| over losses at the same points."""
    kernel, plain = kernel.double().cpu(), plain.double().cpu()
    return float(((kernel - plain).abs() / plain.abs()).max())


def phase_subspace_lm(dev: torch.device, arch: str) -> int:
    """Subspace Newton (paper §III-§IV lifted to the LM) on ``arch`` at
    published widths, [lm]'s depth, weights and batch: two steps on the
    kernel route from one generator; the randomized line search from the
    second step's parameters along its momentum, on both routes from one
    seed; the first step again on the plain route (``use_kernels=False``)
    from a generator seeded as the first.  Each loss the plain route takes
    at a point the kernel route took (the m samples and θ of step 1, the
    line's candidates) is held to it.  Returns the arch's kernel launches
    in the kernel-route legs."""
    counter = LM_KERNEL[arch][0]
    t0 = time.perf_counter()
    cfg, batch, params, _ = lm_model(
        arch, batch_size=2, seq_len=LM_SEQ_LEN, seed=SUBSPACE_WORKLOAD_SEED,
        full_width=True, n_layers=LM_DEPTH[arch], device=dev)
    seen = []

    def loss_of(model_cfg):
        loss_fn = transformer.make_loss_fn(model_cfg)

        def loss(p):
            out = loss_fn(p, batch)[0]
            seen.append(out)
            return out
        return loss

    loss = loss_of(cfg)
    plain_loss = loss_of(dataclasses.replace(cfg, use_kernels=False))
    n_layers, m = cfg.n_layers, SUBSPACE_CFG.m_resolved()
    per_step = (m + SUBSPACE_CFG.p_line + 1) * n_layers
    state0 = init_state(params)
    n_params = state0["momentum"].numel()
    print(f"[subspace lm] {arch}: {n_layers} layers at published widths, P "
          f"= {n_params}, basis {SUBSPACE_CFG.k * n_params * 4 / 1e9:.2f} GB "
          f"(k = {SUBSPACE_CFG.k}, f32), m = {m}, p = "
          f"{SUBSPACE_CFG.p_line}, sample_scale {SUBSPACE_CFG.sample_scale}")
    gen = torch.Generator(device=dev).manual_seed(SUBSPACE_SEED)
    launches, state, cur = 0, state0, params
    for i in range(2):
        seen.clear()
        cur, state, info, wall, counts, peak = _subspace_step(
            dev, loss, cur, state, gen)
        if i == 0:
            info1, at_step1 = info, torch.stack(seen[:m] + seen[-1:])
        launches += counts[counter]
        print(f"[subspace lm] {arch} step {i + 1} (kernel route): loss "
              f"{info['loss_before']:.6f} -> {info['loss_after']:.6f}, α "
              f"{info['alpha']:.4f}, ‖g‖ {info['grad_norm']:.4g}; wall "
              f"{wall:.2f}s, peak device memory {peak:.2f} GiB, {counter} "
              f"{counts[counter]} (want {per_step})")
        check(math.isfinite(info["loss_after"])
              and math.isfinite(info["grad_norm"]),
              f"{arch} step {i + 1}: a loss or ‖g‖ is not finite")
        check(counts[counter] == per_step
              and counts["flash_attention_launches"]
              == counts["flash_attention_wgmma_launches"]
              and counts["wkv6_launches"] == counts["wkv6_chunked_launches"],
              f"{arch} step {i + 1}: launches {counts}, want {per_step} of "
              f"{counter}")
    # the momentum after two steps is zero only if neither step moved
    norm = float(torch.linalg.vector_norm(state["momentum"]))
    check(norm > 0, f"{arch}: neither step moved")
    update = map_tree(lambda v: v[0], basis_to_tree(state["momentum"][None],
                                                    cur))
    line = {}
    for route, fn in (("kernel", loss), ("plain", plain_loss)):
        seen.clear()
        gen = torch.Generator(device=dev).manual_seed(SUBSPACE_SEED + 1)
        (_, alpha, best), wall, counts, peak = _leg(
            dev, lambda: randomized_line_search(fn, cur, update, gen,
                                                SUBSPACE_LINE, device=dev))
        line[route] = torch.stack(seen)
        print(f"[subspace lm] {arch} line search ({route} route) from step "
              f"2's parameters along its momentum (‖·‖ {norm:.4g}), p = "
              f"{SUBSPACE_LINE.p}: best α {float(alpha):.4f}, loss "
              f"{float(best):.6f} (at α = 1: {float(seen[0]):.6f}); wall "
              f"{wall:.2f}s, peak device memory {peak:.2f} GiB, {counter} "
              f"{counts[counter]}")
        if route == "kernel":
            launches += counts[counter]
            check(counts[counter] == SUBSPACE_LINE.p * n_layers,
                  f"{arch}: the line search launched {counts[counter]} "
                  f"kernels")
        else:
            check(counts["flash_attention_launches"]
                  == counts["wkv6_launches"] == 0,
                  f"{arch}: the plain line search launched a kernel")
    line_gap = _route_gap(line["kernel"], line["plain"])
    del cur, state, update
    seen.clear()
    _, _, plain, wall, counts, peak = _subspace_step(
        dev, plain_loss, params, state0,
        torch.Generator(device=dev).manual_seed(SUBSPACE_SEED))
    step_gap = _route_gap(at_step1, torch.stack(seen[:m] + seen[-1:]))
    print(f"[subspace lm] {arch} step 1 (plain route, the same draws): loss "
          f"{plain['loss_before']:.6f} -> {plain['loss_after']:.6f}, α "
          f"{plain['alpha']:.4f} (kernel route {info1['alpha']:.4f}); wall "
          f"{wall:.2f}s, peak device memory {peak:.2f} GiB, kernel "
          f"launches {counts['flash_attention_launches']} / "
          f"{counts['wkv6_launches']}")
    print(f"[subspace lm] {arch} kernel route against plain route, largest "
          f"relative gap: step 1's {m} samples and θ {step_gap:.3g}, the "
          f"line's {SUBSPACE_LINE.p} candidates {line_gap:.3g} (gate "
          f"{SUBSPACE_ROUTE_TOL}); phase wall {time.perf_counter() - t0:.1f}s")
    check(counts["flash_attention_launches"] == counts["wkv6_launches"] == 0,
          f"{arch}: the plain route launched a kernel")
    check(max(step_gap, line_gap) <= SUBSPACE_ROUTE_TOL,
          f"{arch}: kernel route {step_gap} / {line_gap} from the plain "
          f"route")
    del params, state0, seen, at_step1, line
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _lm_act2(dev, arch, search, fleet, backend, n_layers) -> None:
    """Act 2 on act 1's workload (danube; rwkv6's acts 2 and 3 run in
    ``[pod lm]``'s lm_subspace substrate smoke): the arch's kernel once
    per layer per lane evaluated."""
    counter = LM_KERNEL[arch][0]
    act2 = dataclasses.replace(search, anm=dataclasses.replace(
        search.anm, max_iterations=LM_ACT2_ITERATIONS))
    _zero_counts()
    lanes0 = backend.lanes_evaluated
    t0 = time.perf_counter()
    res, wall_co, ok, wall_solo = anm_lm.portfolio(act2, fleet, backend, 2)
    wall = time.perf_counter() - t0
    lanes = backend.lanes_evaluated - lanes0
    launches = getattr(ops, counter)
    co = res.coalesce_stats
    print(f"[lm] {arch} act 2: 2 searches of {act2.anm.max_iterations} "
          f"iterations coalesced {wall_co:.1f}s ({co.dispatches} dispatches "
          f"for {co.lane_blocks} blocks), solo re-runs {wall_solo:.1f}s, "
          f"coalesced == solo: {ok}, best "
          f"{res.best.engine.best_fitness:.6f}; wall {wall:.1f}s, {lanes} "
          f"lanes, {counter} {launches}")
    check(ok, f"{arch} act 2: the bit-identity gate failed")
    check(launches == lanes * n_layers > 0, f"{arch} act 2: {launches} "
          f"kernel launches for {lanes} lanes x {n_layers} layers")


def _norm_err(got: torch.Tensor, want: torch.Tensor):
    """(‖got - want‖ / ‖want‖, the worst row's) over (rows, V) logits."""
    diff = got.float() - want.float()
    rows = diff.norm(dim=-1) / want.float().norm(dim=-1)
    return float(diff.norm() / want.float().norm()), float(rows.max())


def _serve_model(arch: str, dtype: str, gen, dev):
    """``arch`` at published widths cut to SERVE_DEPTH layers, random
    parameters from ``gen`` in ``dtype``."""
    cfg = dataclasses.replace(cut_depth(get_config(arch), SERVE_DEPTH[arch]),
                              dtype=dtype)
    return cfg, transformer.init_params(cfg, gen, dev)


def _serve_loop(dev, cfg, params, spec: dict, seed: int) -> dict:
    """``launch/serve.py``'s loop over ``spec``'s requests with top-40
    sampling from a card generator: every request gets its tokens, all
    inside the vocabulary, no logit NaN.  Returns the loop's stream ms per
    decode step (CUDA events around the whole loop), steps, wall."""
    rng = np.random.default_rng(seed)
    queue = [rng.integers(1, cfg.vocab_size, spec["prompt"])
             for _ in range(spec["requests"])]
    gen = torch.Generator(device=dev).manual_seed(seed)
    nans = []

    def sampler(logits):
        nans.append(torch.isnan(logits).any())
        return serve.sample_logits(logits, gen)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    res = serve.serve(params, cfg, queue, sampler, batch=spec["batch"],
                      gen_len=spec["gen"], max_seq=spec["max_seq"])
    end.record()
    torch.cuda.synchronize(dev)
    toks = [t for out in res.outputs.values() for t in out]
    check(all(len(out) == spec["gen"] for out in res.outputs.values()),
          f"{cfg.name}: a request got fewer than {spec['gen']} tokens")
    check(all(0 <= t < cfg.vocab_size for t in toks),
          f"{cfg.name}: a sampled token lies outside the vocabulary")
    check(not bool(torch.stack(nans).any()), f"{cfg.name}: a NaN logit")
    return dict(ms=start.elapsed_time(end) / res.steps, steps=res.steps,
                wall=res.wall_s, tokens=len(toks))


def _decode_logits(cfg, params, toks, dev, absorb=False) -> torch.Tensor:
    """(S, V) logits of ``toks`` (1, S) fed one at a time through the serve
    step from an empty cache of S rows (a ring of the window's rows); MLA
    through the latent space with ``absorb``."""
    step = transformer.make_serve_step(cfg, absorb=absorb)
    cache = transformer.init_cache(cfg, 1, toks.shape[1], device=dev)
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = step(params, cache, toks[:, t:t + 1], t)
        outs.append(logits[0, 0])
    return torch.stack(outs)


def _prefill_logits(cfg, params, toks) -> tuple:
    """(S, V) logits of one prefill with ``use_kernels`` (the attention or
    wkv6 kernel once per layer), and the launches it made."""
    _zero_counts()
    step = transformer.make_prefill_step(dataclasses.replace(
        cfg, use_kernels=True))
    logits = step(params, {"tokens": toks})[0]
    torch.cuda.synchronize()
    return logits, _counts()


def _kernel_launches(cfg, counts: dict) -> str:
    """The prefill's launches of its arch's kernel, checked: one per block
    that runs it (an RWKV6 block: wkv6; an attention or shared-attention
    block: the attention kernel; a Mamba2 block: none), all of them of the
    variant ops routes its type to; none for MLA, which attends through
    the dense path as the reference."""
    if cfg.mla is not None:
        check(not any(counts.values()), f"{cfg.name}: the MLA prefill "
              f"launched {counts}, want no kernel")
        return "no kernel launched (MLA attends densely)"
    kinds = cfg.blocks()
    want = kinds.count("rwkv6")
    if want:
        names = ("wkv6_launches", "wkv6_chunked_launches"
                 if cfg.dtype == "bfloat16" else "wkv6_serial_launches")
    else:
        want = kinds.count("attn") + kinds.count("shared_attn")
        names = ("flash_attention_launches",
                 "flash_attention_wgmma_launches"
                 if cfg.dtype == "bfloat16" and cfg.resolved_head_dim % 8 == 0
                 else "flash_attention_simt_launches")
    total, variant = (counts[n] for n in names)
    check(total == variant == want > 0 and sum(counts.values()) == 2 * want,
          f"{cfg.name}: prefill launched {counts}, want {want} {names[1]}")
    return f"{names[1]} {variant}"


def _match_tokens(cfg, n_tokens: int, seed: int, dev) -> torch.Tensor:
    """(1, n_tokens) seeded tokens of the decode == prefill legs."""
    return torch.randint(0, cfg.vocab_size, (1, n_tokens), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed))


def _decode_vs_prefill(dev, cfg, params, n_tokens: int, seed: int):
    """Decode == prefill on ``n_tokens`` seeded tokens; returns (decode
    logits, the comparison printed, the prefill's launches printed)."""
    toks = _match_tokens(cfg, n_tokens, seed, dev)
    dec = _decode_logits(cfg, params, toks, dev)
    pre, counts = _prefill_logits(cfg, params, toks)
    launches = _kernel_launches(cfg, counts)
    if cfg.dtype == "float32":          # the reference's gate
        err = float((dec - pre).abs().max())
        ok = bool(torch.all((dec - pre).abs() <= 2e-3 + 2e-3 * pre.abs()))
        what = f"max |err| {err:.3g} (gate 2e-3 + 2e-3 |ref|)"
    else:
        norm, row = _norm_err(dec, pre)
        ok = norm <= SERVE_BF16_NORM
        what = (f"‖err‖/‖ref‖ {norm:.4g} (gate {SERVE_BF16_NORM}), worst "
                f"row {row:.4g}")
    check(ok and bool(torch.isfinite(pre).all()), f"{cfg.name} "
          f"{cfg.dtype}: decode != prefill over {n_tokens} tokens: {what}")
    return dec, what, launches


def _cache_bytes(cfg, batch: int, max_seq: int) -> int:
    return sum(math.prod(x.shape) * x.dtype.itemsize for _, x in
               leaves_with_paths(transformer.init_cache(
                   cfg, batch, max_seq, as_shape=True)))


def _free() -> None:
    """Return what the caller has just deleted to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def _refuses(fn, exc) -> bool:
    """True if ``fn()`` raises ``exc`` (a refusal the port must make)."""
    try:
        fn()
    except exc:
        return True
    return False


def _serve_tp(dev: torch.device, cfg, params) -> int:
    """(s1): ``launch/serve.py --ranks 2 --model-ranks 2`` on ``cfg``
    (danube at published widths, (d)'s depth) over 2 gloo ranks sharing
    the card, each drawing (d)'s weights ``params`` from the launcher's
    seed and keeping its model block (16 of the 32 query heads, 4 of the
    8 kv heads, half the vocabulary) and its block of the caches' rows:
    (a) a prefill of SERVE_TP's seeded tokens with the attention kernel,
    once a layer a rank, within SERVE_TP_NORM normwise of this process's
    prefill of them on ``params``; (b) the decode of their first
    positions within SERVE_BF16_NORM of that prefill; (c) (d)'s serve
    loop, every rank the same tokens inside the vocabulary, no NaN logit;
    (d) every collective kind a rank hands in the decode's first step and
    in the prefill equal to the dry-run's entries of that kind for those
    cells on (1, 2) (``dryrun.handed``); (e) printed: ms a decode step,
    gloo's share of it, and each rank's peak beside the reckoned ones.
    Returns the ranks' attention kernel launches."""
    t0 = time.perf_counter()
    m, n_dec = SERVE_TP["ranks"], SERVE_TP["decode"]
    toks = _match_tokens(cfg, SERVE_TP["prefill"], SERVE_TP["token_seed"],
                         dev)
    one, counts = _prefill_logits(cfg, params, toks)
    want = _kernel_launches(cfg, counts)
    spec = SERVE_OTHER
    argv = ["--ranks", str(m), "--model-ranks", str(m), "--dist-backend",
            "gloo", "--seed", str(SERVE_TP["seed"]), "--requests",
            str(spec["requests"]), "--batch", str(spec["batch"]),
            "--prompt-len", str(spec["prompt"]), "--gen-len",
            str(spec["gen"]), "--max-seq", str(spec["max_seq"])]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_s1_") as tmp:
        np.save(os.path.join(tmp, "tokens.npy"), toks.cpu().numpy())
        t1 = time.perf_counter()
        res, _ = serve.over_ranks(argv, cfg=dataclasses.asdict(cfg), probe={
            "tokens": os.path.join(tmp, "tokens.npy"), "decode_len": n_dec,
            "max_seq": SERVE_TP["max_seq"], "use_kernels": True,
            "out": os.path.join(tmp, "{}.pt")})
        t2 = time.perf_counter()
        check(res.returncode == 0, f"(s1) the serve run over ranks failed: "
              f"{res.failed}")
        pre = torch.load(os.path.join(tmp, "prefill.pt"))[0].to(dev)
        dec = torch.load(os.path.join(tmp, "decode.pt"))[0].to(dev)
    docs = res.docs
    pre_norm, pre_row = _norm_err(pre, one)
    dec_norm, dec_row = _norm_err(dec, one[:n_dec])
    del pre, dec, one
    _free()
    for phase in ("prefill", "decode"):
        check(all(d[phase]["finite"] and d[phase]["digest"]
                  == docs[0][phase]["digest"] for d in docs),
              f"(s1) the ranks' {phase} logits differ or are not finite")
    kinds = [_kernel_launches(cfg, {k: d["prefill"]["launches"][k]
                                    for k in LAUNCH_COUNTERS})
             for d in docs]
    check(all(not any(d["decode"]["launches"][k] for k in LAUNCH_COUNTERS)
              for d in docs), "(s1) a decode step launched a kernel")
    flash = sum(d["prefill"]["launches"]["flash_attention_launches"]
                for d in docs)
    outs = [d["outputs"] for d in docs]
    toks_ok = all(o == outs[0] for o in outs) and all(
        len(t) == spec["gen"] and all(0 <= x < cfg.vocab_size for x in t)
        for t in outs[0].values()) and len(outs[0]) == spec["requests"]
    nan = sum(d["nan_logits"] for d in docs)
    # (d) each kind a rank hands against the dry-run's cells on (1, 2)
    mesh = dryrun.rank_cell_mesh(m, m)
    reports = {
        "decode": dryrun.reckon(cfg, ShapeConfig(
            "s1d", SERVE_TP["max_seq"], 1, "decode"), mesh),
        "prefill": dryrun.reckon(cfg, ShapeConfig(
            "s1p", SERVE_TP["prefill"], 1, "prefill"), mesh)}
    held, equal = [], True
    for phase, report in reports.items():
        parts = []
        counted = [d["decode"]["first_step"] if phase == "decode"
                   else d["prefill"] for d in docs]
        for kind in sharding.MODEL_KINDS:
            want_b, want_n = dryrun.handed(report, kind, m)
            got = [(c["bytes"][kind], c["calls"][kind]) for c in counted]
            same = all(g == (want_b, want_n) for g in got)
            equal = equal and same
            if want_b or got[0][0]:
                parts.append(f"{kind} {got[0][0]} B in {got[0][1]} "
                             f"(dry-run {want_b} B in {want_n}; {same})")
        held.append(f"{phase}: " + ", ".join(parts))
    d0 = docs[0]["decode"]
    step_ms = 1e3 * d0["wall_s"] / n_dec
    gloo = sum(d0["seconds"].values()) / d0["wall_s"]
    peaks = [round(d["peak_bytes"] / 2**30, 3) for d in docs]
    reckoned = {p: round(r["memory_analysis"]["peak_size_bytes"] / 2**30, 3)
                for p, r in reports.items()}
    print(f"[serve] (s1) {cfg.name} {len(cfg.blocks())} blocks {cfg.dtype} "
          f"over "
          f"{m} gloo ranks sharing {dev} (launch/serve.py --ranks {m} "
          f"--model-ranks {m}, the (1, {m}) mesh; heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} -> {cfg.n_heads // m}/{cfg.n_kv_heads // m} a "
          f"rank, the vocabulary cut, each rank {SERVE_TP['max_seq'] // m} "
          f"of the cache's {SERVE_TP['max_seq']} rows): (a) prefill of "
          f"{tuple(toks.shape)} seeded tokens, a rank's launches {kinds}, "
          f"the gathered logits against this process's prefill (its "
          f"{want}) ‖err‖/‖ref‖ {pre_norm:.4g} (gate {SERVE_TP_NORM}), "
          f"worst row {pre_row:.4g}, every rank the same bits; (b) decode "
          f"over {n_dec} positions against that prefill ‖err‖/‖ref‖ "
          f"{dec_norm:.4g} (gate {SERVE_BF16_NORM}), worst row "
          f"{dec_row:.4g}; (c) {spec['requests']} requests at batch "
          f"{spec['batch']}: every rank the same tokens inside the "
          f"vocabulary {toks_ok}, NaN logits {nan}, {docs[0]['steps']} "
          f"steps in {docs[0]['serve_wall_s']:.2f}s; (d) a rank's "
          f"collectives against the dry-run's cells on (1, {m}): "
          f"{'; '.join(held)}: equal {equal}; (e) {step_ms:.3f} ms a "
          f"decode step (synchronized, {n_dec} steps, the prefill "
          f"{1e3 * docs[0]['prefill']['wall_s']:.1f} ms), gloo "
          f"{100 * gloo:.1f} % of it (its collectives' seconds with the "
          f"card synchronized on either side), peak {peaks} GiB a rank "
          f"against the reckoned per-device peaks on (1, {m}) {reckoned} "
          f"GiB; ranks {t2 - t1:.1f}s with their starts, leg "
          f"{time.perf_counter() - t0:.1f}s")
    check(pre_norm <= SERVE_TP_NORM, f"(s1) the prefill over ranks lies "
          f"{pre_norm:.3g} from one process's")
    check(dec_norm <= SERVE_BF16_NORM, f"(s1) decode over ranks != prefill: "
          f"{dec_norm:.3g}")
    check(toks_ok and nan == 0, "(s1) the ranks' tokens differ, leave the "
          "vocabulary or a logit is NaN")
    check(equal, "(s1) a collective kind's bytes or calls differ from the "
          "dry-run's entries of that kind")
    return flash


def phase_serve(dev: torch.device) -> tuple:
    """``launch/serve.py`` and the serve / prefill steps at published
    widths; returns the attention and wkv6 kernels' launches in it (and
    the attention kernel's in (s1)'s ranks), and (a)'s counted step for
    ``phase_dryrun``."""
    _zero_counts()
    launches = {"flash_attention": 0, "wkv6": 0}

    def add(counts: dict) -> None:
        launches["flash_attention"] += counts["flash_attention_launches"]
        launches["wkv6"] += counts["wkv6_launches"]

    gen = torch.Generator(device=dev).manual_seed(20)
    # (a) qwen2-72b serves 16 requests at batch 8
    t0 = time.perf_counter()
    cfg, params = _serve_model("qwen2-72b", "bfloat16", gen, dev)
    blocks = sum(x.numel() * x.element_size()
                 for _, x in leaves_with_paths(params["segments"]))
    head = params["head"]["w"]
    bound = (blocks + head.numel() * head.element_size()) / HBM_BW
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    leg = _serve_loop(dev, cfg, params, SERVE_MAIN, seed=1)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # the device's share of a step: one serve step at t = 300 over the
    # loop's cache shape replayed from a CUDA graph, and the sampler alone
    batch = SERVE_MAIN["batch"]
    cache = transformer.init_cache(cfg, batch, SERVE_MAIN["max_seq"],
                                   device=dev)
    step = transformer.make_serve_step(cfg)
    tokens = torch.ones((batch, 1), dtype=torch.long, device=dev)
    step_ms = _graph_ms(lambda: step(params, cache, tokens, 300), calls=10,
                        replays=5)
    logits = step(params, cache, tokens, 300)[0][:, 0]
    sample_gen = torch.Generator(device=dev).manual_seed(7)
    sample_ms = _events_ms(lambda: serve.sample_logits(logits, sample_gen),
                           iters=20)
    del logits
    _free()
    # (d2)'s real step: one more at t = 300, untimed, its products counted
    d2 = _counted_step(dev, lambda: step(params, cache, tokens, 300))
    del d2["out"], cache
    _free()
    d2.update(where="[serve] (a)", cfg=cfg, optimizer=None,
              shape=ShapeConfig("a", SERVE_MAIN["max_seq"], batch, "decode"),
              ms=step_ms, hand_bound_ms=bound * 1e3)
    print(f"[serve] (a) qwen2-72b {len(cfg.blocks())} blocks, "
          f"{transformer.count_params(params) / 1e9:.2f} G parameters bf16: "
          f"{SERVE_MAIN['requests']} requests at batch {SERVE_MAIN['batch']} "
          f"(prompt {SERVE_MAIN['prompt']}, {SERVE_MAIN['gen']} generated, "
          f"max_seq {SERVE_MAIN['max_seq']}): {leg['tokens']} tokens in "
          f"{leg['steps']} decode steps, loop wall {leg['wall']:.2f}s, "
          f"{leg['ms']:.3f} ms per step (CUDA events around the loop) "
          f"against a bound of {bound * 1e3:.3f} ms (block weights "
          f"{blocks / 1e9:.2f} GB + head "
          f"{head.numel() * head.element_size() / 1e9:.2f} GB once at "
          f"3.35 TB/s); peak device memory {peak:.2f} GiB; one serve step "
          f"from a CUDA graph {step_ms:.3f} ms ({step_ms / (bound * 1e3):.2f}"
          f"x the bound) and the sampler {sample_ms:.3f} ms, so the loop's "
          f"stream waits on the host "
          f"{100 * max(0.0, 1 - (step_ms + sample_ms) / leg['ms']):.0f} % "
          f"of a step; leg wall {time.perf_counter() - t0:.1f}s")
    # (b) decode == prefill over 300 tokens in bf16 (wgmma) ...
    t0 = time.perf_counter()
    dec_bf16, what, kl = _decode_vs_prefill(dev, cfg, params,
                                            SERVE_MATCH_LEN, seed=2)
    add(_counts())
    print(f"[serve] (b) qwen2-72b bf16 decode == prefill over "
          f"{SERVE_MATCH_LEN} tokens: {what}; prefill {kl}; wall "
          f"{time.perf_counter() - t0:.1f}s")
    # (c) ... the same tokens through the int8 cache
    t0 = time.perf_counter()
    qcfg = dataclasses.replace(cfg, quantized_cache=True)
    toks = _match_tokens(cfg, SERVE_MATCH_LEN, 2, dev)
    dec_int8 = _decode_logits(qcfg, params, toks, dev)
    norm, row = _norm_err(dec_int8, dec_bf16)
    print(f"[serve] (c) qwen2-72b int8 cache against the bf16 cache over "
          f"{SERVE_MATCH_LEN} tokens: ‖err‖/‖ref‖ {norm:.4g} (gate "
          f"{SERVE_INT8_NORM}), worst row {row:.4g}; cache bytes at batch "
          f"{SERVE_MAIN['batch']} x {SERVE_MAIN['max_seq']}: int8 "
          f"{_cache_bytes(qcfg, SERVE_MAIN['batch'], SERVE_MAIN['max_seq'])}"
          f" against bf16 "
          f"{_cache_bytes(cfg, SERVE_MAIN['batch'], SERVE_MAIN['max_seq'])};"
          f" wall {time.perf_counter() - t0:.1f}s")
    check(norm <= SERVE_INT8_NORM and bool(torch.isfinite(dec_int8).all()),
          f"int8 cache logits {norm} from the bf16 cache's")
    del params, dec_bf16, dec_int8
    _free()
    # (b) ... and in f32 (the SIMT attention kernel)
    t0 = time.perf_counter()
    cfg, params = _serve_model("qwen2-72b", "float32", gen, dev)
    _, what, kl = _decode_vs_prefill(dev, cfg, params, SERVE_MATCH_LEN,
                                     seed=2)
    add(_counts())
    print(f"[serve] (b) qwen2-72b f32 decode == prefill over "
          f"{SERVE_MATCH_LEN} tokens: {what}; prefill {kl}; wall "
          f"{time.perf_counter() - t0:.1f}s")
    del params
    _free()
    # (d) the other archs: serve, then decode == prefill in bf16; danube's
    # weights from (s1)'s launcher seed, then (s1) over ranks on them
    for arch in ("deepseek-coder-33b", "command-r-plus-104b",
                 "chameleon-34b", "h2o-danube-3-4b", "rwkv6-7b"):
        t0 = time.perf_counter()
        cfg, params = _serve_model(
            arch, "bfloat16", torch.Generator(device=dev).manual_seed(
                SERVE_TP["seed"]) if arch == "h2o-danube-3-4b" else gen, dev)
        leg = _serve_loop(dev, cfg, params, SERVE_OTHER, seed=3)
        _, what, kl = _decode_vs_prefill(dev, cfg, params, SERVE_OTHER_LEN,
                                         seed=4)
        add(_counts())
        print(f"[serve] (d) {arch} {len(cfg.blocks())} blocks bf16: "
              f"{SERVE_OTHER['requests']} requests at batch "
              f"{SERVE_OTHER['batch']}, {leg['tokens']} tokens in "
              f"{leg['steps']} steps, {leg['ms']:.3f} ms per step; decode "
              f"== prefill over {SERVE_OTHER_LEN} tokens: {what}; prefill "
              f"{kl}; wall {time.perf_counter() - t0:.1f}s")
        if arch == "h2o-danube-3-4b":
            launches["flash_attention_ranks"] = _serve_tp(dev, cfg, params)
        del params
        _free()
    # (d) the danube smoke config's ring of 16 rows wraps twice
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"),
                              dtype="float32")
    params = transformer.init_params(cfg, gen, dev)
    check(transformer.init_cache(cfg, 1, 48, as_shape=True)[0][0]["k"]
          .shape[2] == cfg.sliding_window == 16, "danube smoke: no ring")
    _, what, kl = _decode_vs_prefill(dev, cfg, params, 48, seed=5)
    add(_counts())
    print(f"[serve] (d) h2o-danube-3-4b smoke f32, window "
          f"{cfg.sliding_window}: 48 decode steps through the ring == "
          f"prefill: {what}; prefill {kl}")
    # (e) hubert-xlarge's encoder forward on the dense non-causal route
    t0 = time.perf_counter()
    cfg, params = _serve_model("hubert-xlarge", "float32", gen, dev)
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = map_tree(lambda x: x.to(torch.bfloat16), params)
    emb = torch.randn((2, 512, cfg.d_model), generator=gen, device=dev)
    mask = torch.rand((2, 512), generator=gen, device=dev) < 0.3
    _zero_counts()
    f32 = transformer.make_prefill_step(cfg)(params, {"embeds": emb,
                                                      "mask": mask})
    bf16 = transformer.make_prefill_step(bcfg)(
        bparams, {"embeds": emb.to(torch.bfloat16), "mask": mask})
    torch.cuda.synchronize(dev)
    counts = _counts()
    norm, row = _norm_err(bf16, f32)
    refused = _refuses(lambda: serve.serve(
        bparams, bcfg, [np.ones(4)], lambda lg: lg.argmax(-1), batch=1,
        gen_len=1, max_seq=8), ValueError)
    print(f"[serve] (e) hubert-xlarge {len(cfg.blocks())} blocks: encoder "
          f"forward over {tuple(emb.shape)} frame embeddings -> logits "
          f"{tuple(f32.shape)}, bf16 against f32 ‖err‖/‖ref‖ {norm:.4g} "
          f"(gate {SERVE_BF16_NORM}), worst row {row:.4g}; kernel launches "
          f"{counts['flash_attention_launches']} (dense route); the serve "
          f"loop refuses it: {refused}; wall {time.perf_counter() - t0:.1f}s")
    check(tuple(f32.shape) == (2, 512, cfg.vocab_size)
          and bool(torch.isfinite(f32).all() and torch.isfinite(bf16).all()),
          "hubert: encoder logits of the wrong shape or not finite")
    check(norm <= SERVE_BF16_NORM, f"hubert: bf16 logits {norm} from f32")
    check(counts["flash_attention_launches"] == 0,
          "hubert: the non-causal encoder launched the attention kernel")
    check(refused, "hubert: the serve loop took an encoder")
    del params, bparams
    _free()
    print(f"[serve] kernel launches in the phase: {launches}")
    check(launches["flash_attention"] > 0 and launches["wkv6"] > 0,
          f"[serve] launched no kernel: {launches}")
    return launches, d2


@contextlib.contextmanager
def _routing(forced=None):
    """Within: each MoE routing of the port recorded, per call, as (its
    experts, its margin: k-th minus (k+1)-th router probability); with
    ``forced`` (a one-row prefill's record), each decode step's MoE layers
    take the experts that prefill chose at the step's position."""
    own = layers._route
    calls = []

    def route(x, router, k):
        probs, gates, idx = own(x, router, k)
        top = torch.topk(probs, k + 1, dim=-1).values
        calls.append((idx, top[..., k - 1] - top[..., k]))
        if forced is not None:
            t, layer = divmod(len(calls) - 1, len(forced))
            idx = forced[layer][0][:, t:t + 1]
            gates = torch.gather(probs, -1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        return probs, gates, idx
    layers._route = route
    try:
        yield calls
    finally:
        layers._route = own


def _first_flips(pre_calls, dec_calls, n_tokens: int) -> list:
    """The prefill margin at each token's first layer where its decode
    chose other experts than its prefill (tokens that never flip left
    out)."""
    n_moe = len(pre_calls)
    seen = torch.zeros(n_tokens, dtype=torch.bool)
    margins = []
    for layer, (idx, margin) in enumerate(pre_calls):
        dec = torch.cat([dec_calls[t * n_moe + layer][0]
                         for t in range(n_tokens)], dim=1)
        flip = (dec.sort(-1).values != idx.sort(-1).values).any(-1)[0].cpu()
        new = flip & ~seen
        margins += margin[0].cpu()[new].tolist()
        seen |= flip
    return margins


def _moe_decode_vs_prefill(dev, cfg, params, n_tokens: int, seed: int):
    """bf16 decode == prefill of a MoE model (see MOE_TIE_MARGIN): the
    decode fed the prefill's experts within SERVE_BF16_NORM; the free
    decode's distance, its tokens that flip, each first at a near-tie.
    Returns (the prefill's record, the fed decode's logits, the
    comparison printed, the prefill's launches printed)."""
    toks = _match_tokens(cfg, n_tokens, seed, dev)
    with _routing() as pre_calls:
        pre, counts = _prefill_logits(cfg, params, toks)
    launches = _kernel_launches(cfg, counts)
    with _routing() as dec_calls:
        free = _decode_logits(cfg, params, toks, dev)
    with _routing(forced=pre_calls):
        fed = _decode_logits(cfg, params, toks, dev)
    norm, row = _norm_err(fed, pre)
    free_norm, free_row = _norm_err(free, pre)
    flips = _first_flips(pre_calls, dec_calls, n_tokens)
    worst = max(flips, default=0.0)
    what = (f"fed the prefill's experts ‖err‖/‖ref‖ {norm:.4g} (gate "
            f"{SERVE_BF16_NORM}), worst row {row:.4g}; free routing "
            f"{free_norm:.4g}, worst row {free_row:.4g}, {len(flips)} of "
            f"{n_tokens} tokens take other experts, each first at a "
            f"prefill margin ≤ {worst:.3g} (gate {MOE_TIE_MARGIN})")
    check(norm <= SERVE_BF16_NORM and worst < MOE_TIE_MARGIN
          and bool(torch.isfinite(pre).all() and torch.isfinite(free).all()),
          f"{cfg.name} {cfg.dtype}: decode != prefill over {n_tokens} "
          f"tokens: {what}")
    return pre_calls, fed, what, launches


def _no_drop(cfg):
    """``cfg`` with the MoE capacity at which its prefills drop nothing."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_NO_DROP))


def _moe_model(arch: str, dtype: str, gen, dev):
    """``_serve_model`` with its draw's wall and peak memory, and the
    decode step's bytes bound: every block weight (the capacity buffer
    runs every expert each step) and the head, once at the HBM rate.
    Returns (cfg, params, line printed)."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg, params = _serve_model(arch, dtype, gen, dev)
    torch.cuda.synchronize(dev)
    drawn = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    blocks = sum(x.numel() * x.element_size()
                 for _, x in leaves_with_paths(params["segments"]))
    head = params["head"]["w"]
    head = head.numel() * head.element_size()
    bound = (blocks + head) / HBM_BW * 1e3
    line = (f"{len(cfg.blocks())} blocks, "
            f"{transformer.count_params(params) / 1e9:.2f} G parameters "
            f"{dtype} drawn in {drawn:.1f}s (peak {peak:.2f} GiB)")
    return cfg, params, dict(line=line, bound=bound, blocks=blocks,
                             head=head)


def _serve_leg(dev, cfg, params, info) -> str:
    """The serve loop on SERVE_OTHER beside the bytes bound, its peak."""
    torch.cuda.reset_peak_memory_stats(dev)
    leg = _serve_loop(dev, cfg, params, SERVE_OTHER, seed=3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    return (f"{SERVE_OTHER['requests']} requests at batch "
            f"{SERVE_OTHER['batch']}, {leg['tokens']} tokens in "
            f"{leg['steps']} steps, {leg['ms']:.3f} ms per step (CUDA events "
            f"around the loop) against a bound of {info['bound']:.3f} ms "
            f"(block weights {info['blocks'] / 1e9:.2f} GB + head "
            f"{info['head'] / 1e9:.2f} GB once at 3.35 TB/s), loop wall "
            f"{leg['wall']:.2f}s, peak {peak:.2f} GiB")


def phase_serve_moe(dev: torch.device) -> int:
    """MLA and MoE at published widths through the serve loop, the serve
    and prefill steps and the loss; returns the attention kernel's
    launches in the phase."""
    launches = 0
    gen = torch.Generator(device=dev).manual_seed(22)
    arch = "deepseek-v2-lite-16b"
    # (f) deepseek-v2-lite-16b whole, bf16
    t0 = time.perf_counter()
    cfg, params, info = _moe_model(arch, "bfloat16", gen, dev)
    served = _serve_leg(dev, cfg, params, info)
    batch = SERVE_OTHER["batch"]
    cache = transformer.init_cache(cfg, batch, SERVE_OTHER["max_seq"],
                                   device=dev)
    step = transformer.make_serve_step(cfg)
    tokens = torch.ones((batch, 1), dtype=torch.long, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = _graph_ms(lambda: step(params, cache, tokens, 100), calls=5,
                        replays=5)
    graph_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del cache
    _free()
    print(f"[serve moe] (f) {arch} {info['line']}: {served}; one serve step "
          f"replayed from a CUDA graph {step_ms:.3f} ms "
          f"({step_ms / info['bound']:.2f}x the bound), peak "
          f"{graph_peak:.2f} GiB; wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    roomy = _no_drop(cfg)
    pre_calls, dec, what, kl = _moe_decode_vs_prefill(
        dev, roomy, params, SERVE_OTHER_LEN, seed=4)
    launches += _counts()["flash_attention_launches"]
    toks = _match_tokens(cfg, SERVE_OTHER_LEN, 4, dev)
    with _routing(forced=pre_calls):
        dec_int8 = _decode_logits(dataclasses.replace(
            roomy, quantized_cache=True), params, toks, dev)
    norm, row = _norm_err(dec_int8, dec)
    check(norm <= SERVE_INT8_NORM and bool(torch.isfinite(dec_int8).all()),
          f"{arch}: int8 latent cache logits {norm} from the bf16 cache's")
    prefill = transformer.make_prefill_step(cfg)
    once = prefill(params, {"tokens": toks})
    twice = prefill(params, {"tokens": toks})
    same = bool(torch.equal(once, twice))
    check(same, f"{arch}: the same prefill gave other bits the second time")
    drop_norm, _ = _norm_err(once[0], transformer.make_prefill_step(roomy)(
        params, {"tokens": toks})[0])
    q, b = (_cache_bytes(dataclasses.replace(cfg, quantized_cache=True),
                         batch, SERVE_OTHER["max_seq"]),
            _cache_bytes(cfg, batch, SERVE_OTHER["max_seq"]))
    print(f"[serve moe] (f) {arch} bf16, capacity {MOE_NO_DROP:g}: decode "
          f"== prefill over {SERVE_OTHER_LEN} tokens: {what}; prefill {kl}; "
          f"int8 latent cache against the bf16 cache ‖err‖/‖ref‖ "
          f"{norm:.4g} (gate {SERVE_INT8_NORM}; both fed the prefill's "
          f"experts), worst row {row:.4g}; latent "
          f"cache bytes at batch {batch} x {SERVE_OTHER['max_seq']}: int8 "
          f"{q} against bf16 {b}; at the published capacity "
          f"{cfg.moe.capacity_factor} the prefill is the same bits twice: "
          f"{same}, and lies ‖·‖ {drop_norm:.4g} from the capacity "
          f"{MOE_NO_DROP:g} prefill (dropped tokens); wall "
          f"{time.perf_counter() - t0:.1f}s")
    del params, dec, dec_int8, once, twice, pre_calls
    _free()
    # (f') deepseek-v2-lite-16b cut to MLA_F32_DEPTH layers, f32
    t0 = time.perf_counter()
    cfg = _no_drop(dataclasses.replace(cut_depth(get_config(arch),
                                                 MLA_F32_DEPTH),
                                       dtype="float32"))
    params = transformer.init_params(cfg, gen, dev)
    naive, what, kl = _decode_vs_prefill(dev, cfg, params, SERVE_OTHER_LEN,
                                         seed=5)
    absorbed = _decode_logits(cfg, params, _match_tokens(
        cfg, SERVE_OTHER_LEN, 5, dev), dev, absorb=True)
    gap = float((absorbed - naive).abs().max())
    ok = bool(torch.all((absorbed - naive).abs()
                        <= 2e-4 + 2e-4 * naive.abs()))
    print(f"[serve moe] (f') {arch} {MLA_F32_DEPTH} layers f32, capacity "
          f"{MOE_NO_DROP:g}: decode == prefill over {SERVE_OTHER_LEN} "
          f"tokens: {what}; prefill {kl}; absorb == naive decode: max |err| "
          f"{gap:.3g} (gate 2e-4 + 2e-4 |naive|); wall "
          f"{time.perf_counter() - t0:.1f}s")
    check(ok, f"{arch}: the absorbed MLA decode differs from the naive one "
          f"by {gap}")
    del params, naive, absorbed
    _free()
    # (g) llama4-maverick cut to one dense and one MoE layer, bf16
    arch = "llama4-maverick-400b-a17b"
    t0 = time.perf_counter()
    cfg, params, info = _moe_model(arch, "bfloat16", gen, dev)
    served = _serve_leg(dev, cfg, params, info)
    _, _, what, kl = _moe_decode_vs_prefill(dev, _no_drop(cfg), params,
                                            SERVE_OTHER_LEN, seed=4)
    launches += _counts()["flash_attention_launches"]
    print(f"[serve moe] (g) {arch} {info['line']}: {served}; capacity "
          f"{MOE_NO_DROP:g}: decode == prefill over {SERVE_OTHER_LEN} "
          f"tokens: {what}; prefill {kl}; wall "
          f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    rng = np.random.default_rng(22)
    rows, seq = MOE_LOSS_SHAPE
    loss_batch = {name: torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (rows, seq)), device=dev)
        for name in ("tokens", "labels")}
    out = {}
    with torch.no_grad():
        for route, use_kernels in (("kernel", True), ("plain", False)):
            fn = transformer.make_loss_fn(dataclasses.replace(
                cfg, use_kernels=use_kernels))
            (loss, met), wall, counts, peak = _leg(dev, lambda: fn(
                params, loss_batch))
            out[route] = dict(loss=float(loss), ce=float(met["ce"]),
                              aux=float(met["aux"]), wall=wall, peak=peak,
                              counts=counts)
    k, p = out["kernel"], out["plain"]
    gaps = {name: abs(k[name] - p[name]) / abs(p[name])
            for name in ("loss", "ce")}
    kc = k["counts"]
    print(f"[serve moe] (g) {arch} loss over {rows} x {seq} tokens at the "
          f"published capacity {cfg.moe.capacity_factor}: kernel route "
          f"loss {k['loss']:.6f} = ce {k['ce']:.6f} + 0.01 aux "
          f"{k['aux']:.6f} ({k['wall']:.2f}s, peak {k['peak']:.2f} GiB, "
          f"flash_attention_wgmma_launches "
          f"{kc['flash_attention_wgmma_launches']}); plain route loss "
          f"{p['loss']:.6f}, ce {p['ce']:.6f}, aux {p['aux']:.6f} "
          f"({p['wall']:.2f}s, peak {p['peak']:.2f} GiB); relative gap loss "
          f"{gaps['loss']:.3g}, ce {gaps['ce']:.3g} (gate {MOE_LOSS_TOL}); "
          f"wall {time.perf_counter() - t0:.1f}s")
    check(kc["flash_attention_launches"]
          == kc["flash_attention_wgmma_launches"] == cfg.n_layers,
          f"{arch}: the kernel-route loss launched {kc}, want "
          f"{cfg.n_layers} wgmma launches")
    check(not any(p["counts"].values()), f"{arch}: the plain-route loss "
          f"launched {p['counts']}")
    check(all(math.isfinite(r[n]) for r in (k, p)
              for n in ("loss", "ce", "aux"))
          and max(gaps.values()) <= MOE_LOSS_TOL,
          f"{arch}: kernel-route loss against plain route {gaps}")
    launches += kc["flash_attention_launches"]
    del params
    _free()
    print(f"[serve moe] attention kernel launches in the phase: {launches}")
    return launches


def _fed_decode(cfg, params, toks, dev):
    """Decode == prefill block by block.  The prefill (``use_kernels``)
    records each block's input and output at every position; the decode
    runs twice: free, and fed, each block's step taking the input the
    prefill gave that block at the step's position (its caches then hold
    what the prefill's inputs make).  Returns (prefill logits, its
    launches, free logits, fed logits, per block ‖free - prefill‖ /
    ‖prefill‖ and the same fed, over the blocks' outputs)."""
    own = transformer._apply_block
    ins, outs, seen = [], [], []
    feed = None

    def traced(x, *args, **kw):
        if feed is not None:
            block, t = divmod(len(seen), len(ins))[::-1]
            x = ins[block][:, t:t + 1] if feed else x
        else:
            ins.append(x)
        out = own(x, *args, **kw)
        (seen if feed is not None else outs).append(out[0])
        return out
    transformer._apply_block = traced
    try:
        pre, counts = _prefill_logits(cfg, params, toks)
        gaps, logits = {}, {}
        for feed in (False, True):
            seen.clear()
            logits[feed] = _decode_logits(cfg, params, toks, dev)
            n = len(outs)
            gaps[feed] = [float((torch.cat(seen[b::n], dim=1).float()
                                 - outs[b].float()).norm()
                                / outs[b].float().norm()) for b in range(n)]
    finally:
        transformer._apply_block = own
    return pre, counts, logits[False], logits[True], gaps[False], gaps[True]


def phase_serve_hybrid(dev: torch.device) -> int:
    """Mamba2 and the weight-shared attention block (zamba2-2.7b) at its
    published widths through the serve loop, the serve and prefill steps
    and the loss; returns the attention kernel's launches in the phase."""
    arch = HYBRID_ARCH
    gen = torch.Generator(device=dev).manual_seed(23)
    launches = 0
    # (h) zamba2-2.7b whole, bf16
    t0 = time.perf_counter()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(arch)
    params = transformer.init_params(cfg, gen, dev)
    torch.cuda.synchronize(dev)
    drawn = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    stored = transformer.count_params(params)
    weights = sum(x.numel() * x.element_size()
                  for _, x in leaves_with_paths(params))
    batch, max_seq = SERVE_OTHER["batch"], SERVE_OTHER["max_seq"]
    caches = _cache_bytes(cfg, batch, max_seq)
    bound = (weights + caches) / HBM_BW * 1e3
    torch.cuda.reset_peak_memory_stats(dev)
    leg = _serve_loop(dev, cfg, params, SERVE_OTHER, seed=3)
    loop_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    cache = transformer.init_cache(cfg, batch, max_seq, device=dev)
    step = transformer.make_serve_step(cfg)
    tokens = torch.ones((batch, 1), dtype=torch.long, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = _graph_ms(lambda: step(params, cache, tokens, 100), calls=5,
                        replays=5)
    graph_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del cache
    _free()
    print(f"[serve hybrid] (h) {arch} {len(cfg.blocks())} blocks "
          f"({cfg.n_layers} Mamba2, {cfg.blocks().count('shared_attn')} "
          f"applications of the shared block), {stored} parameters stored "
          f"(n_params {cfg.n_params()}), bf16, drawn in {drawn:.1f}s (peak "
          f"{draw_peak:.2f} GiB); {SERVE_OTHER['requests']} requests at "
          f"batch {batch}, {leg['tokens']} tokens in {leg['steps']} steps, "
          f"{leg['ms']:.3f} ms per step (CUDA events around the loop) "
          f"against a bound of {bound:.3f} ms (weights {weights / 1e9:.3f} GB"
          f" + caches {caches / 1e6:.1f} MB once at 3.35 TB/s), loop wall "
          f"{leg['wall']:.2f}s, peak {loop_peak:.2f} GiB; one serve step "
          f"replayed from a CUDA graph {step_ms:.3f} ms "
          f"({step_ms / bound:.2f}x the bound), peak {graph_peak:.2f} GiB; "
          f"wall {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    toks = _match_tokens(cfg, SERVE_OTHER_LEN, 4, dev)
    pre, counts, free, fed, free_gaps, fed_gaps = _fed_decode(
        cfg, params, toks, dev)
    kl = _kernel_launches(cfg, counts)
    launches += counts["flash_attention_launches"]
    norm, row = _norm_err(fed, pre)
    free_norm, free_row = _norm_err(free, pre)
    twice, counts = _prefill_logits(cfg, params, toks)
    launches += counts["flash_attention_launches"]
    same = bool(torch.equal(pre, twice))
    print(f"[serve hybrid] (h) {arch} bf16, the free decode's "
          f"‖decode - prefill‖ / ‖prefill‖ over each block's output: "
          + ", ".join(f"{i} {g:.3g}" for i, g in enumerate(free_gaps)))
    print(f"[serve hybrid] (h) {arch} bf16 decode == prefill over "
          f"{SERVE_OTHER_LEN} tokens: each block fed the prefill's input "
          f"‖err‖/‖ref‖ {norm:.4g} (gate {SERVE_BF16_NORM}), worst row "
          f"{row:.4g}, worst block {max(fed_gaps):.3g} (gate "
          f"{SERVE_BF16_NORM}); free {free_norm:.4g}, worst row "
          f"{free_row:.4g}, growing by at most "
          f"{max(b - a for a, b in zip([0.0] + free_gaps, free_gaps)):.3g} "
          f"a block; prefill {kl}; the prefill the same bits twice: {same}; "
          f"wall {time.perf_counter() - t0:.1f}s")
    check(norm <= SERVE_BF16_NORM and max(fed_gaps) <= SERVE_BF16_NORM
          and bool(torch.isfinite(pre).all() and torch.isfinite(fed).all()
                   and torch.isfinite(free).all()),
          f"{arch} bf16: the fed decode != prefill over {SERVE_OTHER_LEN} "
          f"tokens: {norm} (worst row {row}, worst block {max(fed_gaps)})")
    check(same, f"{arch}: the same prefill gave other bits the second time")
    del free, fed, pre, twice
    # (i) the loss over HYBRID_LOSS_SHAPE seeded tokens, kernel route
    # against the plain route (the dense _attend)
    t0 = time.perf_counter()
    rng = np.random.default_rng(23)
    rows, seq = HYBRID_LOSS_SHAPE
    loss_batch = {name: torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (rows, seq)), device=dev)
        for name in ("tokens", "labels")}
    out = {}
    with torch.no_grad():
        for route, use_kernels in (("kernel", True), ("plain", False)):
            fn = transformer.make_loss_fn(dataclasses.replace(
                cfg, use_kernels=use_kernels))
            (loss, met), wall, counts, peak = _leg(dev, lambda: fn(
                params, loss_batch))
            out[route] = dict(loss=float(loss), ce=float(met["ce"]),
                              wall=wall, peak=peak, counts=counts)
    k, p = out["kernel"], out["plain"]
    gap = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    kc = k["counts"]
    n_attn = cfg.blocks().count("shared_attn")
    print(f"[serve hybrid] (i) {arch} loss over {rows} x {seq} tokens: "
          f"kernel route {k['loss']:.6f} ({k['wall']:.2f}s, peak "
          f"{k['peak']:.2f} GiB, flash_attention_wgmma_launches "
          f"{kc['flash_attention_wgmma_launches']}); plain route "
          f"{p['loss']:.6f} ({p['wall']:.2f}s, peak {p['peak']:.2f} GiB); "
          f"relative gap {gap:.3g} (gate {HYBRID_LOSS_TOL}); ln vocab "
          f"{math.log(cfg.vocab_size):.6f}; wall "
          f"{time.perf_counter() - t0:.1f}s")
    check(kc["flash_attention_launches"]
          == kc["flash_attention_wgmma_launches"] == n_attn
          and sum(kc.values()) == 2 * n_attn,
          f"{arch}: the kernel-route loss launched {kc}, want {n_attn} "
          f"wgmma launches")
    check(not any(p["counts"].values()), f"{arch}: the plain-route loss "
          f"launched {p['counts']}")
    check(all(math.isfinite(r[n]) for r in (k, p) for n in ("loss", "ce"))
          and k["loss"] == k["ce"] and gap <= HYBRID_LOSS_TOL,
          f"{arch}: kernel-route loss {k['loss']} against plain route "
          f"{p['loss']}")
    launches += kc["flash_attention_launches"]
    del params
    _free()
    # (h') cut to HYBRID_F32_BLOCKS blocks, f32: one set of shared weights
    # over two caches
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cut_depth(get_config(arch), HYBRID_F32_BLOCKS),
                              dtype="float32")
    params = transformer.init_params(cfg, gen, dev)
    _, what, kl = _decode_vs_prefill(dev, cfg, params, SERVE_OTHER_LEN,
                                     seed=5)
    launches += _counts()["flash_attention_launches"]
    print(f"[serve hybrid] (h') {arch} {len(cfg.blocks())} blocks "
          f"({cfg.n_layers} Mamba2, {cfg.blocks().count('shared_attn')} "
          f"applications of one shared block) f32: decode == prefill over "
          f"{SERVE_OTHER_LEN} tokens: {what}; prefill {kl}; wall "
          f"{time.perf_counter() - t0:.1f}s")
    del params
    _free()
    print(f"[serve hybrid] attention kernel launches in the phase: "
          f"{launches}")
    return launches


#: (t1): examples/train_lm.py's full command line (``launch/train_lm.py``
#: builds it), 100 steps (its 200 cut in half), a checkpoint every 50
TRAIN_LM_STEPS = 100
#: the loss of lm-100m must fall from step 1 to step 100 by at least this
#: (the lower edge of the prediction in PERF.md §6)
TRAIN_LM_MIN_FALL = 4.0
#: (t2): tests/test_system.py:111's crash and restart
TRAIN_CRASH_ARGV = ["--preset", "tiny", "--steps", "12", "--ckpt-every", "4",
                    "--batch", "2", "--seq", "32"]
#: (t3): h2o-danube-3-4b at its published width and depth, the launcher's
#: default batch and sequence, three AdamW steps at lr 1e-4: the weights
#: are bf16 with no f32 master copy, as the reference's, and a weight of
#: danube's init scale (d^-0.5 = 0.016) has an ulp of 1.2e-4, so a smaller
#: step leaves most of them where they were; AdamW's first step moves
#: every weight by about lr, and with no warm-up the loss rises over
#: these three steps (PERF.md §6)
TRAIN_DANUBE = dict(batch=8, seq=128, steps=3, lr=1e-4)
#: [dryrun]: the reckoned peak (argument + the traced peak beside it)
#: against the card's max_memory_allocated of the same step, relative
DRYRUN_MEM_TOL = 0.15
#: [dryrun]: the traced peak beside the arguments against the card's rise
#: from the step's start to its peak, relative (PERF.md §6: 15.675 GiB
#: traced against 15.677-15.678 GiB on the card for (d1))
DRYRUN_RISE_TOL = 0.03
#: AdamW's bytes a parameter (bf16 p and g read; f32 mu, nu read and
#: written; bf16 p written) and the products' FLOP a parameter a token
#: (forward 2, backward 4, remat's recompute 2)
ADAMW_BYTES_PER_PARAM = 22
TRAIN_FLOP_PER_PARAM_TOKEN = 8
#: (t4): the card's f32 step against the CPU's: loss relative, gradients
#: and new parameters normwise a leaf
TRAIN_CPU_LOSS_TOL = 1e-5
TRAIN_CPU_TOL = 1e-4
#: (t5): benchmarks/train_throughput.py's shape and settings on lm-100m
TRAIN_BENCH = dict(batch=4, seq=128, p=8, k=4, sample_scale=0.05)
#: (t7): lm-100m (the launcher's preset, bf16) over 2 gloo ranks sharing
#: the card, the global batch of 8 x 128 cut in two, 5 AdamW steps
TRAIN_RANKS = 2
TRAIN_RANKS_ARGV = ["--preset", "lm-100m", "--batch", "8", "--seq", "128",
                    "--steps", "5", "--log-every", "1"]
#: (t7): each step's loss over the ranks against the one-process step on
#: the hosts' concatenated batches, relative (the bf16 loss tolerance,
#: ROADMAP C)
TRAIN_RANKS_LOSS_TOL = 2e-2
#: (t8): the tiny preset over a one-rank NCCL group and in this process
TRAIN_NCCL_ARGV = ["--preset", "tiny", "--batch", "2", "--seq", "32",
                   "--steps", "4", "--log-every", "100"]
#: (t9): h2o-danube-3-4b at published widths cut to this many layers, its
#: parameters cut over TRAIN_RANKS gloo ranks (--fsdp), at TRAIN_DANUBE's
#: batch, sequence, steps and lr; ``--fsdp-probe`` runs the published
#: depth for TRAIN_FSDP_PROBE_STEPS steps
TRAIN_FSDP_LAYERS = 2
TRAIN_FSDP_PROBE_STEPS = 2
#: (t9): the ranks' final blocks, put together, against the one-process
#: parameters, normwise a leaf, relative (bf16's tolerance on losses and
#: logits, ROADMAP C)
TRAIN_FSDP_PARAM_TOL = 2e-2
#: (t10): (t9)'s danube, depth, batch, steps and lr over TRAIN_TP_RANKS
#: gloo ranks on the (1, TRAIN_TP_RANKS) mesh, the parameters cut over
#: the model axis (--model-ranks), held to (t9)'s gates against the
#: launcher's one-process run
TRAIN_TP_RANKS = TRAIN_RANKS
#: (t11): deepseek-v2-lite at published widths cut to this many layers
#: (the dense first layer and a MoE segment stacked twice), at (t10)'s
#: batch, steps, lr and mesh: MLA's heads, the experts (all-to-alls) and
#: the shared experts cut over the model axis across the ranks
TRAIN_TP_MOE_ARCH = "deepseek-v2-lite-16b"
TRAIN_TP_MOE_LAYERS = 3
#: (t11): a token whose router probabilities at its k-th and (k+1)-th
#: choices lie closer than this is near-tied (ROADMAP C: bf16 MoE tests
#: leave such tokens out where they compare tokens' outputs)
TRAIN_TP_MOE_TIE = 1e-3
#: (t12), (t13): RWKV6 and Zamba2 at published widths cut to this many
#: blocks (rwkv6-7b's 2 layers, one stacked segment; zamba2-2.7b's 6
#: Mamba2 layers and one application of its weight-shared block), at
#: (t10)'s batch, steps, lr and mesh: RWKV6's heads and channel mix,
#: Mamba2's inner channels (its norm's statistic all-reduced) and the
#: shared block cut over the model axis across the ranks
TRAIN_TP_SSM = (("t12", "rwkv6-7b", 2), ("t13", "zamba2-2.7b", 7))
#: (t12), (t13): a leaf the initialisation sets to zero (Mamba2's conv
#: biases and dt_bias) holds only its steps' updates, so its normwise gap
#: is one relative to them, not to its initial values: in bf16 the two
#: runs round some near-zero gradient elements to opposite signs, and
#: AdamW's first steps move each such element by ±lr whatever its size.
#: Such a leaf is held to this, each other leaf to TRAIN_FSDP_PARAM_TOL
TRAIN_TP_UPDATE_TOL = 0.25


def _launch_train(argv, env, timeout=600):
    """``python -m repro_torch.launch.train`` in a child process (forked,
    ``launch/child.py``); its exit code, stdout and stderr."""
    return child.run("repro_torch.launch.train", argv, env, timeout)


def _train_lines(text: str) -> list:
    return [json.loads(line.split(" ", 1)[1]) for line in text.splitlines()
            if line.startswith("[train] {")]


def _sync_ms(dev, fn, iters: int) -> float:
    """Host wall per call of ``fn`` over ``iters`` calls ended by a
    synchronize, after one warm-up call: a training step as its caller
    pays for it."""
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize(dev)
    return 1e3 * (time.perf_counter() - t0) / iters


def phase_train(dev: torch.device) -> tuple:
    """Training on the card through src/repro_torch/launch/train.py: (t1)
    lm-100m, (t2) crash and restart, (t3) danube at published width and
    depth, (t4) card == CPU in f32, (t5) throughput of the step, its line
    search and subspace Newton, (t6) int8 gradient compression, (t7)-(t13)
    over ranks (``_train_over_ranks``).  No kernel
    runs (training is ``use_kernels=False``, as the reference's launcher);
    a backward through a kernel route is refused.  Returns (t3)'s counted
    step for ``phase_dryrun`` and the kernels' launches in (t10)-(t13)'s
    ranks."""
    _zero_counts()
    gen = torch.Generator(device=dev).manual_seed(0)

    # (t3) first, on an empty card: danube, published width and depth
    _free()
    t0 = time.perf_counter()
    cfg = get_config("h2o-danube-3-4b")
    params = transformer.init_params(cfg, gen, dev)
    n = transformer.count_params(params)
    opt = AdamW(lr=TRAIN_DANUBE["lr"], weight_decay=0.01)
    state = opt.init(params)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_DANUBE["seq"],
        global_batch=TRAIN_DANUBE["batch"], seed=0))
    step = transformer.make_train_step(cfg, opt)
    first = params["segments"][0][0]["mlp"]["w_in"][0, :4, :4].clone()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls, losses = [], []
    for i in range(TRAIN_DANUBE["steps"]):
        batch = train.batch_to(data.batch(i), cfg, dev)
        t1 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize(dev)
        walls.append(1e3 * (time.perf_counter() - t1))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    # the step's two halves, timed apart once
    t1 = time.perf_counter()
    grads, _, _ = transformer.value_and_grad(transformer.make_loss_fn(cfg),
                                             params, batch)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    params, state = opt.update(grads, state, params)
    torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    del grads
    moved = not torch.equal(
        params["segments"][0][0]["mlp"]["w_in"][0, :4, :4], first)
    tokens = TRAIN_DANUBE["batch"] * TRAIN_DANUBE["seq"]
    adamw_ms = 1e3 * ADAMW_BYTES_PER_PARAM * n / HBM_BW
    flop_ms = 1e3 * TRAIN_FLOP_PER_PARAM_TOKEN * n * tokens / PEAK_FLOPS
    # (d1)'s real step: one more, untimed, its products counted
    d1 = _counted_step(dev, lambda: step(params, state, batch))
    params, state, metrics = d1.pop("out")
    d1.update(where="[train] (t3)", cfg=cfg, optimizer=opt,
              shape=ShapeConfig("t3", TRAIN_DANUBE["seq"],
                                TRAIN_DANUBE["batch"], "train"),
              ms=float(np.median(walls[1:])),
              hand_bound_ms=adamw_ms + flop_ms)
    state_gb = (2 * n + 2 * n + 8 * n) / 1e9
    ms = min(walls[1:])
    print(f"[train] (t3) {cfg.name} {cfg.n_layers} layers (published), d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, {n:,} params bf16, remat "
          f"{cfg.remat}; batch {TRAIN_DANUBE['batch']} x seq "
          f"{TRAIN_DANUBE['seq']}: losses {losses}, ms a step "
          f"{[round(w, 1) for w in walls]} (best after the first {ms:.1f}); "
          f"bound {adamw_ms:.1f} (AdamW {ADAMW_BYTES_PER_PARAM} B a param) + "
          f"{flop_ms:.1f} (8·N·tokens bf16) = {adamw_ms + flop_ms:.1f} ms, "
          f"{ms / (adamw_ms + flop_ms):.2f}x (forward + backward "
          f"{1e3 * (t2 - t1):.1f} ms, AdamW {1e3 * (t3 - t2):.1f} ms, timed "
          f"apart once); reckoned state {state_gb:.1f} "
          f"GB (params, grads, mu + nu), peak {peak:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f}s")
    check(all(math.isfinite(x) for x in losses), "danube's loss is not "
          "finite")
    check(moved, "danube's parameters did not change")
    del params, state, metrics, batch, step, first
    _free()

    # (t1) lm-100m through the launcher, examples/train_lm.py's command line
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        log = os.path.join(tmp, "log.jsonl")
        out = io.StringIO()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train.main(train_lm.example_argv(
                steps=TRAIN_LM_STEPS, ckpt_dir=tmp)
                + ["--log-every", "1", "--log-file", log])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        lines = _train_lines(out.getvalue())
        saved = sorted(d for d in os.listdir(tmp) if d.startswith("step_"))
    loss = {x["step"]: x["loss"] for x in lines}
    ms = float(np.median([x["ms_per_step"] for x in lines[10:]]))
    params_line = [ln for ln in out.getvalue().splitlines()
                   if "params=" in ln][0]
    print(f"[train] (t1) {params_line.split('] ', 1)[1]}, bf16, "
          f"{' '.join(train_lm.example_argv(steps=TRAIN_LM_STEPS)[:10])}: "
          f"loss at step 1 / 50 / 100 "
          f"{loss[1]} / {loss[50]} / {loss[100]}; {ms:.2f} ms a step "
          f"(median of steps 11-100, a host read each step), "
          f"{4 * 256 / ms * 1e3:,.0f} tokens/s, peak {peak:.2f} GiB, "
          f"checkpoints {saved}; {wall:.1f}s")
    check(rc == 0 and len(lines) == 100, "the lm-100m run did not finish")
    check(loss[1] - loss[100] >= TRAIN_LM_MIN_FALL,
          f"lm-100m's loss fell by {loss[1] - loss[100]:.3f}, predicted at "
          f"least {TRAIN_LM_MIN_FALL}")
    check(saved == ["step_00000050", "step_00000100"],
          f"lm-100m's checkpoints: {saved}")

    # (t2) crash and restart in child processes, resumed == uninterrupted
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_crash_") as tmp:
        crashed, straight = (os.path.join(tmp, d) for d in ("ck", "st"))
        r1 = _launch_train(TRAIN_CRASH_ARGV + ["--ckpt-dir", crashed,
                                               "--crash-at", "9"], env)
        r2 = _launch_train(TRAIN_CRASH_ARGV + ["--ckpt-dir", crashed,
                                               "--resume"], env)
        with contextlib.redirect_stdout(io.StringIO()):    # uninterrupted
            rc = train.main(TRAIN_CRASH_ARGV + ["--ckpt-dir", straight])
        check(r1.returncode == 42, f"the crashed run exited {r1.returncode}: "
              f"{r1.stderr[-2000:]}")
        check(r2.returncode == 0 and rc == 0,
              f"the resumed or uninterrupted run failed: {r2.stderr[-2000:]}")
        a = np.load(os.path.join(crashed, "step_00000012", "arrays.npz"))
        b = np.load(os.path.join(straight, "step_00000012", "arrays.npz"))
        same = sorted(a.files) == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            for k in a.files)
        n_leaves = len(a.files)
    resumed = ("resumed from step 8" in r2.stdout
               and '"step": 12' in r2.stdout)
    print(f"[train] (t2) tiny, crashed and resumed in child processes: crash "
          f"at 9 exit {r1.returncode}; resumed from step 8 to step 12: "
          f"{resumed}; resumed step-12 arrays.npz == an uninterrupted run's "
          f"(in this process), {n_leaves} leaves bit for bit: {same}; "
          f"{time.perf_counter() - t0:.1f}s")
    check(resumed, "the resumed run did not continue from step 8 to step 12")
    check(same, "the resumed run differs from the uninterrupted one")

    # (t4) the card's f32 step against the CPU's, from the same weights
    t0 = time.perf_counter()
    cfg = dataclasses.replace(train.PRESETS["tiny"], dtype="float32")
    cpu_params = transformer.init_params(
        cfg, torch.Generator().manual_seed(4), "cpu")
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)).batch(0)
    got = {}
    for where in ("cpu", dev):
        params = map_tree(lambda x, where=where: x.to(where), cpu_params)
        b = train.batch_to(batch, cfg, where)
        grads, loss, _ = transformer.value_and_grad(
            transformer.make_loss_fn(cfg), params, b)
        opt = AdamW(lr=3e-3, weight_decay=0.01)
        new, _, _ = transformer.make_train_step(cfg, opt)(
            params, opt.init(params), b)
        got[str(where)] = (float(loss), dict(leaves_with_paths(grads)),
                           dict(leaves_with_paths(new)))
    remat_grads, remat_loss, _ = transformer.value_and_grad(
        transformer.make_loss_fn(dataclasses.replace(cfg, remat=True)),
        params, b)                      # the card's, units recomputed
    remat_same = bool(torch.equal(remat_loss, loss)) and all(
        torch.equal(x, got[str(dev)][1][path])
        for path, x in leaves_with_paths(remat_grads))
    (l_cpu, g_cpu, p_cpu), (l_dev, g_dev, p_dev) = got["cpu"], got[str(dev)]
    g_err = p_err = 0.0
    left_out = 0
    for path, g in g_cpu.items():
        gd = g_dev[path].cpu()
        g_err = max(g_err, float(torch.linalg.norm(gd - g)
                                 / torch.linalg.norm(g).clamp(min=1e-30)))
        diff = (gd - g).abs()
        keep = (g.abs() > 10 * diff) | (diff == 0)
        left_out += int((~keep).sum())
        want, pd = p_cpu[path][keep], p_dev[path].cpu()[keep]
        p_err = max(p_err, float(torch.linalg.norm(pd - want)
                                 / torch.linalg.norm(want).clamp(min=1e-30)))
    l_err = abs(l_dev - l_cpu) / abs(l_cpu)
    print(f"[train] (t4) tiny f32, one step on each device from one set of "
          f"weights: loss {l_dev:.7f} / {l_cpu:.7f} ({l_err:.2e} rel), worst "
          f"leaf's gradient {g_err:.2e} and new parameters {p_err:.2e} "
          f"normwise ({left_out} elements whose CPU gradient is within ten "
          f"times its own card-CPU difference left out of the parameters); "
          f"remat on the card gives the plain backward's bits: {remat_same}; "
          f"{time.perf_counter() - t0:.1f}s")
    check(l_err <= TRAIN_CPU_LOSS_TOL and g_err <= TRAIN_CPU_TOL
          and p_err <= TRAIN_CPU_TOL, "the card's f32 step differs from the "
          "CPU's")
    check(remat_same, "remat changed the card's loss or gradients")

    # (t5) benchmarks/train_throughput.py's three numbers on lm-100m
    t0 = time.perf_counter()
    cfg = train.PRESETS["lm-100m"]
    params = transformer.init_params(cfg, gen, dev)
    opt = AdamW(lr=1e-3)
    batch = train.batch_to(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_BENCH["seq"],
        global_batch=TRAIN_BENCH["batch"])).batch(0), cfg, dev)
    tokens = TRAIN_BENCH["batch"] * TRAIN_BENCH["seq"]
    loss_fn = transformer.make_loss_fn(cfg)
    box = {"p": params, "s": opt.init(params), "sn": init_state(params)}
    adamw = train.make_full_step(cfg, opt, device=dev)
    search = train.make_full_step(cfg, opt, line_search=TRAIN_BENCH["p"],
                                  device=dev)
    sn_cfg = SubspaceNewtonConfig(k=TRAIN_BENCH["k"],
                                  sample_scale=TRAIN_BENCH["sample_scale"],
                                  p_line=TRAIN_BENCH["p"])

    def run(step):
        def once():
            box["p"], box["s"], _, _ = step(box["p"], box["s"], None, batch,
                                            train.step_generator(0, 0, dev))
        return once

    def newton():
        box["p"], box["sn"], _ = subspace_newton_step(
            lambda q: loss_fn(q, batch)[0], box["p"], box["sn"], sn_cfg,
            train.step_generator(0, 1, dev), device=dev)
    was = torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(True)
        ms_det = _sync_ms(dev, run(adamw), 10)
        ms_ls = _sync_ms(dev, run(search), 5)
        ms_sn = _sync_ms(dev, newton, 3)
        torch.use_deterministic_algorithms(False)
        ms_free = _sync_ms(dev, run(adamw), 10)
        torch.use_deterministic_algorithms(True)
        ms_det2 = _sync_ms(dev, run(adamw), 10)
    finally:
        torch.use_deterministic_algorithms(was)
    print(f"[train] (t5) lm-100m batch {TRAIN_BENCH['batch']} x seq "
          f"{TRAIN_BENCH['seq']}: train_step_adamw {ms_det:.2f} ms, "
          f"{tokens / ms_det * 1e3:,.0f} tok/s; + line search (p = "
          f"{TRAIN_BENCH['p']}) {ms_ls:.2f} ms, overhead_x "
          f"{ms_ls / ms_det:.2f}; subspace newton (k = {TRAIN_BENCH['k']}, "
          f"sample_scale {TRAIN_BENCH['sample_scale']}, p_line "
          f"{TRAIN_BENCH['p']}, {sn_cfg.m_resolved() + sn_cfg.p_line} "
          f"evaluations) {ms_sn:.2f} ms, overhead_x {ms_sn / ms_det:.2f}; "
          f"deterministic / not / deterministic {ms_det:.2f} / "
          f"{ms_free:.2f} / {ms_det2:.2f} ms; {time.perf_counter() - t0:.1f}s")
    del box, params, adamw, search
    _free()

    # (t6) int8 gradient compression with error feedback on lm-100m
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, gen, dev)
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    state = opt.init(params)
    err = init_error_state(params)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_BENCH["seq"],
        global_batch=TRAIN_BENCH["batch"]))
    losses, worst, nonzero = [], 0.0, True
    for i in range(10):
        grads, loss, _ = transformer.value_and_grad(
            loss_fn, params, train.batch_to(data.batch(i), cfg, dev))
        quanta = [torch.max(torch.abs(g.float() + e)) / 127.0 for g, e in
                  zip((g for _, g in leaves_with_paths(grads)),
                      (e for _, e in leaves_with_paths(err)))]
        grads, err = compress_grads(grads, err)
        params, state = opt.update(grads, state, params)
        ratio = torch.stack([torch.max(torch.abs(e)) / q.clamp(min=1e-30)
                             for (_, e), q in zip(leaves_with_paths(err),
                                                  quanta)])
        worst = max(worst, float(ratio.max()))
        nonzero = nonzero and all(bool(torch.any(e != 0))
                                  for _, e in leaves_with_paths(err))
        losses.append(float(loss))
    print(f"[train] (t6) lm-100m --compress-grads, 10 steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; residual nonzero in every "
          f"leaf every step: {nonzero}, worst max|e| / quantum "
          f"{worst:.3f}; {time.perf_counter() - t0:.1f}s")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "the compressed run's loss did not fall")
    check(nonzero and worst <= 1.0, "the error state is zero or past a "
          "quantum")
    del params, state, err, grads
    _free()

    tp_launches = _train_over_ranks(dev)

    # no kernel ran; a backward through a kernel route is refused
    counts = _counts()
    cfg = dataclasses.replace(get_smoke_config("h2o-danube-3-4b"),
                              use_kernels=True)
    params = transformer.init_params(cfg, gen, dev)
    opt = AdamW()
    batch = train.batch_to(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)).batch(0),
        cfg, dev)
    refused = _refuses(lambda: transformer.make_train_step(cfg, opt)(
        params, opt.init(params), batch), RuntimeError)
    print(f"[train] launches across (t1)-(t13): {counts}; a train step of "
          f"{cfg.name} with use_kernels=True on the card refused: {refused}")
    check(not any(counts.values()), "a kernel launched on the training path")
    check(refused and not any(_counts().values()),
          "a backward through the kernel route was not refused")
    return d1, tp_launches


def _train_over_ranks(dev: torch.device) -> dict:
    """Training's data axis over ranks through ``launch/train.py``
    (``over_ranks``, ``launch/ranks.py``): (t7) lm-100m over 2 gloo ranks
    sharing the card against the one-process step on the hosts'
    concatenated batches, every rank's parameters the same bits after
    every step, the gradient bytes a rank hands its all-reduce x 2 equal
    to the dry-run's data-parallel gradient entries on the (2, 1) mesh,
    each rank's peak memory against the reckoned per-device peak, ms a
    step and the all-reduce's share; (t8) the tiny preset over a one-rank
    NCCL group == this process's run bit for bit; (t9)-(t13)
    (``_train_fsdp``, ``_train_tp``, ``_train_tp_moe``,
    ``_train_tp_ssm``).  Returns the kernels' launches in (t10)-(t13)'s
    ranks."""
    t0 = time.perf_counter()
    _free()
    w = TRAIN_RANKS
    res, _ = train.over_ranks(TRAIN_RANKS_ARGV + [
        "--ranks", str(w), "--dist-backend", "gloo"], measure=True)
    check(res.returncode == 0, f"(t7) the run over ranks failed: "
          f"{res.failed}")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        one = train.run(TRAIN_RANKS_ARGV, hosts=w)
    t2 = time.perf_counter()
    docs = res.docs
    steps = len(one["losses"])
    errs = [abs(a - b) / abs(b)
            for a, b in zip(docs[0]["losses"], one["losses"])]
    same = all(d["digests"] == docs[0]["digests"] and d["losses"]
               == docs[0]["losses"] for d in docs) \
        and len(docs[0]["digests"]) == steps
    cfg = train.PRESETS["lm-100m"]
    report = dryrun.reckon(
        cfg, ShapeConfig("t7", 128, 8, "train"),
        Mesh((w, 1), ("data", "model"), virtual_devices(w, dryrun.META)),
        optimizer=AdamW(lr=3e-3, weight_decay=0.01))
    t3 = time.perf_counter()
    reckoned = report["gradient_all_reduce_bytes"]
    per_step = [d["gradient_bytes"] / steps for d in docs]
    bytes_ok = all(d["gradient_all_reduces"] == steps and 2 * p == reckoned
                   for d, p in zip(docs, per_step))
    peak = report["memory_analysis"]["peak_size_bytes"]
    mem_errs = [abs(d["peak_bytes"] - peak) / peak for d in docs]
    step_ms = [round(1e3 * x, 1) for x in docs[0]["step_s"]]
    share = [round(a / s, 3) for a, s in zip(docs[0]["all_reduce_s"],
                                             docs[0]["step_s"])]
    print(f"[train] (t7) {cfg.name} bf16 over {w} gloo ranks sharing "
          f"{dev} (launch/train.py --ranks {w}), global batch 8 x 128, "
          f"{steps} steps: losses {[round(x, 5) for x in docs[0]['losses']]}"
          f" against one process on the hosts' concatenated batches "
          f"{[round(x, 5) for x in one['losses']]} (worst "
          f"{max(errs):.2e} rel, gate {TRAIN_RANKS_LOSS_TOL}); every rank's "
          f"parameters the same bits after every step: {same}; gradient "
          f"bytes a step a rank {per_step[0]:.0f} (one bf16 buffer), x 2 = "
          f"{2 * per_step[0]:.0f} against the dry-run's gradient entries "
          f"{reckoned} on the ({w}, 1) mesh: equal {bytes_ok}; the ring's "
          f"traffic a rank 2(W-1)/W x bytes = "
          f"{2 * (w - 1) / w * per_step[0]:.0f} B a step; loss sums "
          f"{docs[0]['loss_bytes']} B in {docs[0]['loss_all_reduces']} "
          f"all-reduces; ms a step (synchronized) {step_ms}, the gradient "
          f"all-reduce's share {share}; peak "
          f"{[round(d['peak_bytes'] / 2**30, 3) for d in docs]} GiB a rank "
          f"against the reckoned per-device peak {peak / 2**30:.3f} GiB "
          f"({', '.join(f'{100 * e:.2f} %' for e in mem_errs)}); ranks "
          f"{res.wall_s:.1f} s with their starts (each rank's run "
          f"{[round(d['run_s'], 1) for d in docs]} s, its set-up "
          f"{[round(d['setup_s'], 1) for d in docs]} s), the one-process "
          f"run {t2 - t1:.1f} s, the reckoning {t3 - t2:.1f} s; "
          f"{time.perf_counter() - t0:.1f}s")
    check(max(errs) <= TRAIN_RANKS_LOSS_TOL, f"(t7) a loss over ranks is "
          f"{max(errs):.2e} from the one-process step's")
    check(same, "(t7) the ranks' parameters differ")
    check(bytes_ok, "(t7) the gradient bytes differ from the dry-run's")
    check(max(mem_errs) <= DRYRUN_MEM_TOL, f"(t7) a rank's peak is "
          f"{100 * max(mem_errs):.1f} % from the reckoned per-device peak")

    # (t8) the tiny preset over a one-rank NCCL group, and in this process
    t0 = time.perf_counter()
    res, _ = train.over_ranks(TRAIN_NCCL_ARGV + [
        "--ranks", "1", "--dist-backend", "nccl"], measure=True)
    check(res.returncode == 0, f"(t8) the NCCL rank failed: {res.failed}")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        one = train.run(TRAIN_NCCL_ARGV, measure=True)
    doc = res.docs[0]
    same = doc["digests"] == one["digests"] and doc["losses"] == \
        one["losses"]
    print(f"[train] (t8) tiny over a one-rank NCCL group on {doc['device']} "
          f"against this process, {len(one['losses'])} steps: losses "
          f"{[round(x, 5) for x in doc['losses']]}, every step's "
          f"parameters the same bits: {same}; gradient bytes "
          f"{doc['gradient_bytes']} in {doc['gradient_all_reduces']} "
          f"all-reduces; the rank {res.wall_s:.1f} s with its start (its "
          f"run {doc['run_s']:.1f} s), this process's run "
          f"{time.perf_counter() - t1:.1f} s; "
          f"{time.perf_counter() - t0:.1f}s")
    check(same, "(t8) the one-rank NCCL run differs from one process")

    _train_fsdp(dev, TRAIN_FSDP_LAYERS)
    legs = [_train_tp(dev, TRAIN_FSDP_LAYERS), _train_tp_moe(dev)]
    legs += [_train_tp_ssm(dev, *leg) for leg in TRAIN_TP_SSM]
    return {name: sum(leg[name] for leg in legs)
            for name in LAUNCH_COUNTERS}


def _reckon_fsdp(cfg, w: int, fsdp: bool, model: int = 1) -> dict:
    """``dryrun.reckon`` of (t9)'s step of ``cfg`` on meta over the (w, 1)
    mesh, or the (1, ``model``) mesh, with the launcher's AdamW."""
    shape = (1, model) if model > 1 else (w, 1)
    return dryrun.reckon(
        cfg, ShapeConfig("t9", TRAIN_DANUBE["seq"], TRAIN_DANUBE["batch"],
                         "train"),
        Mesh(shape, ("data", "model"),
             virtual_devices(math.prod(shape), dryrun.META)),
        optimizer=AdamW(lr=TRAIN_DANUBE["lr"], weight_decay=0.01),
        fsdp=fsdp)


def _blocks_against_one(paths: list, cuts: dict, one: dict,
                        apart=frozenset()) -> tuple:
    """The worst normwise relative gap, over the leaves, between the ranks'
    final blocks (``paths``: each rank's ``torch.save`` file), put together
    along each cut dimension (``cuts``), and ``one`` (the one-process
    parameters, by path, on the host), on the card; and the leaves
    compared; and the gaps of the leaves in ``apart``, by path, which
    the worst leaves out."""
    ranked = [torch.load(p, mmap=True) for p in paths]
    worst, gaps = 0.0, {}
    for path, want in one.items():
        parts = [r[path] for r in ranked]
        got = (torch.cat(parts, cuts[path]) if path in cuts else parts[0])
        want = want.cuda().float()
        got = got.cuda().float()
        gap = float(torch.linalg.norm(got - want)
                    / torch.linalg.norm(want).clamp(min=1e-30))
        if path in apart:
            gaps[path] = gap
        else:
            worst = max(worst, gap)
    return worst, len(one), gaps


def _train_fsdp(dev: torch.device, n_layers: int, probe: bool = False
                ) -> None:
    """(t9): ``launch/train.py --ranks 2 --fsdp`` on h2o-danube-3-4b at
    published widths cut to ``n_layers`` layers over 2 gloo ranks sharing
    the card (the phase docstring's gates).  With ``probe`` (the
    published depth, ``--fsdp-probe``) the one-process run and the
    blocks' comparison are left out: one process would hold the whole
    model and its moments beside the ranks' files."""
    t0 = time.perf_counter()
    _free()
    w = TRAIN_RANKS
    steps = TRAIN_FSDP_PROBE_STEPS if probe else TRAIN_DANUBE["steps"]
    published = get_config("h2o-danube-3-4b")
    cfg = cut_depth(published, n_layers)
    fields = dataclasses.asdict(cfg)
    argv = ["--batch", str(TRAIN_DANUBE["batch"]), "--seq",
            str(TRAIN_DANUBE["seq"]), "--steps", str(steps), "--lr",
            str(TRAIN_DANUBE["lr"]), "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fsdp_") as tmp:
        blocks = os.path.join(tmp, "rank{rank}.pt")
        forked = time.time()
        res, _ = train.over_ranks(
            argv + ["--ranks", str(w), "--dist-backend", "gloo", "--fsdp"],
            measure=True, cfg=fields, params_out=None if probe else blocks)
        check(res.returncode == 0, f"(t9) the run over ranks failed: "
              f"{res.failed}")
        t1, exited = time.perf_counter(), time.time()
        docs = res.docs
        if not probe:
            with contextlib.redirect_stdout(io.StringIO()):
                one = train.run(argv, hosts=w, cfg=fields,
                                params_out=os.path.join(tmp, "one.pt"))
            t2 = time.perf_counter()
            shards = sharding.RankShards(Mesh.over_ranks(
                (w, 1), ("data", "model"), rank=0,
                rank_devices=[dev] * w), cfg)
            gap, n_leaves, _ = _blocks_against_one(
                [blocks.format(rank=r) for r in range(w)], shards.cuts,
                torch.load(os.path.join(tmp, "one.pt"), mmap=True))
            t3 = time.perf_counter()
    t4 = time.perf_counter()
    reports = {(n, fsdp): _reckon_fsdp(c, w, fsdp)
               for n, c in ((n_layers, cfg), (published.n_layers, published))
               for fsdp in (True, False)}
    t5 = time.perf_counter()
    report = reports[(n_layers, True)]
    gathered = report["fsdp_all_gather_bytes"]
    scattered = report["fsdp_reduce_scatter_bytes"]
    reduced = report["gradient_all_reduce_bytes"]
    bytes_ok = all(
        d["gather_bytes"] == steps * gathered
        and d["scatter_bytes"] == steps * scattered
        and 2 * d["gradient_bytes"] == steps * reduced for d in docs)
    same = all(d["digests"] == docs[0]["digests"] for d in docs) \
        and len(docs[0]["digests"]) == steps
    same_gnorm = all(d["gnorms"] == docs[0]["gnorms"] for d in docs)
    peak = report["memory_analysis"]["peak_size_bytes"]
    whole_peak = reports[(n_layers, False)]["memory_analysis"][
        "peak_size_bytes"]
    mem_errs = [abs(d["peak_bytes"] - peak) / peak for d in docs]
    d0 = docs[0]
    step_ms = [round(1e3 * x, 1) for x in d0["step_s"]]
    gather_share = [round(a / s, 3) for a, s in zip(d0["gather_s"],
                                                     d0["step_s"])]
    scatter_share = [round(a / s, 3) for a, s in zip(d0["scatter_s"],
                                                      d0["step_s"])]
    big = {fsdp: reports[(published.n_layers, fsdp)]["memory_analysis"][
        "peak_size_bytes"] / 2**30 for fsdp in (True, False)}
    n = sum(math.prod(x.shape) for _, x in
            leaves_with_paths(dryrun.meta_params(cfg)))
    line = (f"[train] (t9) {cfg.name} at published widths, {n_layers} "
            f"layers ({n:,} params {cfg.dtype}, remat {cfg.remat}), over "
            f"{w} gloo ranks sharing {dev} with its parameters cut over them "
            f"(launch/train.py --ranks {w} --fsdp), global batch "
            f"{TRAIN_DANUBE['batch']} x {TRAIN_DANUBE['seq']}, {steps} "
            f"steps at lr {TRAIN_DANUBE['lr']}: losses "
            f"{[round(x, 5) for x in d0['losses']]}")
    if not probe:
        errs = [abs(a - b) / abs(b) for a, b in zip(d0["losses"],
                                                     one["losses"])]
        line += (f" against one process on the hosts' concatenated "
                 f"batches {[round(x, 5) for x in one['losses']]} (worst "
                 f"{max(errs):.2e} rel, gate {TRAIN_RANKS_LOSS_TOL}); the "
                 f"ranks' blocks put together against the one-process "
                 f"parameters, worst leaf {gap:.2e} normwise over "
                 f"{n_leaves} leaves (gate {TRAIN_FSDP_PARAM_TOL})")
    print(line + f"; the whole leaves the same bits on every rank after "
          f"every step: {same}; clip norms "
          f"{[round(g, 4) for g in d0['gnorms']]}, the same on every rank: {same_gnorm}; a step a rank: "
          f"all-gather results {d0['gather_bytes'] // steps} B in "
          f"{d0['gathers'] // steps} gathers, reduce-scatter results "
          f"{d0['scatter_bytes'] // steps} B in {d0['scatters'] // steps}, "
          f"the whole leaves' all-reduce {d0['gradient_bytes'] // steps} B "
          f"x 2, against the dry-run's (fsdp) entries on the ({w}, 1) mesh "
          f"{gathered} / {scattered} and gradient entries {reduced}: equal "
          f"{bytes_ok}; ms a step (synchronized) {step_ms}, the gathers' "
          f"share {gather_share}, the reduce-scatters' {scatter_share}; "
          f"peak {[round(d['peak_bytes'] / 2**30, 3) for d in docs]} GiB a "
          f"rank against the reckoned per-device peak {peak / 2**30:.3f} "
          f"GiB with fsdp ({', '.join(f'{100 * e:.2f} %' for e in mem_errs)}"
          f") and {whole_peak / 2**30:.3f} GiB without; reckoned on meta, "
          f"{published.n_layers}-layer danube's per-device peak on ({w}, 1) "
          f"{big[True]:.3f} GiB with fsdp, {big[False]:.3f} GiB without; "
          f"ranks {res.wall_s:.1f} s with their starts (each rank's run "
          f"{[round(d['run_s'], 1) for d in docs]} s, its set-up "
          f"{[round(d['setup_s'], 1) for d in docs]} s; from the forks to "
          f"each run's start "
          f"{[round(d['clock'][0] - forked, 1) for d in docs]} s, from its end to the last exit "
          f"{[round(exited - d['clock'][1], 1) for d in docs]} s)"
          + ("" if probe else f", the one-process run {t2 - t1:.1f} s, the "
             f"blocks' comparison {t3 - t2:.1f} s")
          + f", the four reckonings {t5 - t4:.1f} s; "
          f"{time.perf_counter() - t0:.1f}s")
    if not probe:
        check(max(errs) <= TRAIN_RANKS_LOSS_TOL, f"(t9) a loss over ranks "
              f"is {max(errs):.2e} from the one-process step's")
        check(gap <= TRAIN_FSDP_PARAM_TOL, f"(t9) the ranks' blocks lie "
              f"{gap:.2e} from the one-process parameters")
    check(same and same_gnorm, "(t9) the ranks' whole leaves or clip norms "
          "differ")
    check(bytes_ok, "(t9) the gathered or reduce-scattered bytes differ "
          "from the dry-run's")
    check(max(mem_errs) <= DRYRUN_MEM_TOL, f"(t9) a rank's peak is "
          f"{100 * max(mem_errs):.1f} % from the reckoned per-device peak")


def _kinds_held(report: dict, docs: list, steps: int, m: int) -> tuple:
    """Every kind of collective a rank's document counts (the model
    group's, ``sharding.ModelShards.model_bytes``; the loss's sums and the
    data-parallel gradient over the data group) against the dry-run's
    entries of that kind on the same mesh (``dryrun.handed``: an
    all-reduce's entry is 2 x the buffer a rank hands, an all-gather's M x
    it, an all-to-all's 1 x): bytes for every kind, and the number for
    all but the gradients', which a rank sums in one flat buffer a type
    (``sharding._sum_flat``) where the dry-run has an entry a leaf.
    Returns (all equal on every rank, rank 0's bytes and calls a step
    beside the dry-run's, kind by kind)."""
    def counted(doc: dict, kind: str) -> tuple:
        if kind == "loss":
            return doc["loss_bytes"], doc["loss_all_reduces"]
        if kind == "data gradient":
            return doc["gradient_bytes"], doc["gradient_all_reduces"]
        return doc["model_bytes"][kind], doc["model_calls"][kind]

    def reckoned(kind: str) -> tuple:
        if kind == "data gradient":
            return report["gradient_all_reduce_bytes"] // 2, None
        return dryrun.handed(report, kind, m)

    parts, equal = [], []
    for kind in (*sharding.MODEL_KINDS, "loss", "data gradient"):
        want_b, want_n = reckoned(kind)
        calls_held = kind not in ("gradient", "data gradient")
        equal.append(all(
            got_b == steps * want_b
            and (not calls_held or got_n == steps * want_n)
            for got_b, got_n in (counted(doc, kind) for doc in docs)))
        got_b, got_n = counted(docs[0], kind)
        parts.append(f"{kind} {got_b // steps} B in {got_n // steps} "
                     f"(dry-run {want_b} B"
                     + (f" in {want_n}" if calls_held else ", bytes only")
                     + f"; equal {equal[-1]})")
    return all(equal), "; ".join(parts)


def _train_tp(dev: torch.device, n_layers: int) -> dict:
    """(t10): ``launch/train.py --ranks 2 --model-ranks 2`` on (t9)'s
    danube over 2 gloo ranks sharing the card, the (1, 2) mesh, against
    the launcher's one-process run of the same steps (the phase
    docstring's gates).  Its one data rank draws one host's batch, not
    (t9)'s two hosts' slices, so it takes a one-process run of its own.
    Returns the kernels' launches in the ranks, by counter."""
    t0 = time.perf_counter()
    _free()
    m = TRAIN_TP_RANKS
    steps = TRAIN_DANUBE["steps"]
    cfg = cut_depth(get_config("h2o-danube-3-4b"), n_layers)
    argv = ["--batch", str(TRAIN_DANUBE["batch"]), "--seq",
            str(TRAIN_DANUBE["seq"]), "--steps", str(steps), "--lr",
            str(TRAIN_DANUBE["lr"]), "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        blocks = os.path.join(tmp, "rank{rank}.pt")
        res, _ = train.over_ranks(
            argv + ["--ranks", str(m), "--model-ranks", str(m),
                    "--dist-backend", "gloo"],
            measure=True, cfg=dataclasses.asdict(cfg), params_out=blocks)
        check(res.returncode == 0, f"(t10) the run over ranks failed: "
              f"{res.failed}")
        t1 = time.perf_counter()
        docs = res.docs
        with contextlib.redirect_stdout(io.StringIO()):
            one = train.run(argv, cfg=dataclasses.asdict(cfg),
                            params_out=os.path.join(tmp, "one.pt"))
        t11 = time.perf_counter()
        gap, n_leaves, _ = _blocks_against_one(
            [blocks.format(rank=r) for r in range(m)], docs[0]["cuts"],
            torch.load(os.path.join(tmp, "one.pt"), mmap=True))
    t2 = time.perf_counter()
    report = _reckon_fsdp(cfg, 1, False, model=m)
    whole_peak = _reckon_fsdp(cfg, 1, False)["memory_analysis"][
        "peak_size_bytes"]
    t3 = time.perf_counter()
    errs = [abs(a - b) / abs(b) for a, b in zip(docs[0]["losses"],
                                                 one["losses"])]
    kinds_ok, held = _kinds_held(report, docs, steps, m)
    bytes_ok = kinds_ok and report["model_all_reduce_bytes"] > 0 \
        and report["vocab_all_reduce_bytes"] > 0
    same = all(d["digests"] == docs[0]["digests"] for d in docs) \
        and len(docs[0]["digests"]) == steps
    same_gnorm = all(d["gnorms"] == docs[0]["gnorms"] for d in docs)
    peak = report["memory_analysis"]["peak_size_bytes"]
    mem_errs = [abs(d["peak_bytes"] - peak) / peak for d in docs]
    launches = {name: sum(d["kernel_launches"][name] for d in docs)
                for name in LAUNCH_COUNTERS}
    d0 = docs[0]
    step_ms = [round(1e3 * x, 1) for x in d0["step_s"]]
    block_s = [round(x["block"], 3) for x in d0["model_s"]]
    block_share = [round(x["block"] / s, 3)
                   for x, s in zip(d0["model_s"], d0["step_s"])]
    vocab_s = [round(x["vocab"], 3) for x in d0["model_s"]]
    print(f"[train] (t10) {cfg.name} at published widths, {n_layers} "
          f"layers, over {m} gloo ranks sharing {dev} with its parameters "
          f"cut over the model axis across them (launch/train.py --ranks "
          f"{m} --model-ranks {m}, the (1, {m}) mesh; heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} -> {cfg.n_heads // m}/"
          f"{cfg.n_kv_heads // m} a rank), global batch "
          f"{TRAIN_DANUBE['batch']} x {TRAIN_DANUBE['seq']}, {steps} steps "
          f"at lr {TRAIN_DANUBE['lr']}: losses "
          f"{[round(x, 5) for x in d0['losses']]} against one process "
          f"{[round(x, 5) for x in one['losses']]} (worst "
          f"{max(errs):.2e} rel, gate {TRAIN_RANKS_LOSS_TOL}); the ranks' "
          f"blocks put together against its parameters, worst leaf "
          f"{gap:.2e} normwise over {n_leaves} leaves (gate "
          f"{TRAIN_FSDP_PARAM_TOL}); the whole leaves the same bits on "
          f"every rank after every step: {same}; clip norms "
          f"{[round(g, 4) for g in d0['gnorms']]}, the same on every rank: "
          f"{same_gnorm}; a step a rank, each kind against the dry-run's "
          f"entries of that kind on (1, {m}) by its relation: {held}: "
          f"equal {bytes_ok}; ms a step "
          f"(synchronized) {step_ms}, the block all-reduces' s {block_s} "
          f"(share {block_share}), the vocabulary cut's s {vocab_s}; peak "
          f"{[round(d['peak_bytes'] / 2**30, 3) for d in docs]} GiB a rank "
          f"against the reckoned per-device peak on (1, {m}) "
          f"{peak / 2**30:.3f} GiB "
          f"({', '.join(f'{100 * e:.2f} %' for e in mem_errs)}) and "
          f"{whole_peak / 2**30:.3f} GiB on (1, 1); kernel launches in the "
          f"ranks {launches}; ranks {res.wall_s:.1f} s with their starts "
          f"(each rank's run {[round(d['run_s'], 1) for d in docs]} s, its "
          f"set-up {[round(d['setup_s'], 1) for d in docs]} s), the "
          f"one-process run {t11 - t1:.1f} s, the blocks' comparison "
          f"{t2 - t11:.1f} s, the two reckonings {t3 - t2:.1f} s; "
          f"{time.perf_counter() - t0:.1f}s")
    check(max(errs) <= TRAIN_RANKS_LOSS_TOL, f"(t10) a loss over ranks is "
          f"{max(errs):.2e} from the one-process step's")
    check(gap <= TRAIN_FSDP_PARAM_TOL, f"(t10) the ranks' blocks lie "
          f"{gap:.2e} from the one-process parameters")
    check(same and same_gnorm, "(t10) the ranks' whole leaves or clip "
          "norms differ")
    check(bytes_ok, "(t10) a collective kind's bytes or calls differ from "
          "the dry-run's entries of that kind")
    check(max(mem_errs) <= DRYRUN_MEM_TOL, f"(t10) a rank's peak is "
          f"{100 * max(mem_errs):.1f} % from the reckoned per-device peak")
    check(not any(launches.values()), "(t10) a kernel launched in a rank")
    return launches


def _near_ties(cfg, argv: list, dev: torch.device) -> list:
    """The tokens of the first step's batch whose routing is near-tied
    (``TRAIN_TP_MOE_TIE``) in each MoE layer of the launcher's initial
    parameters (its seed), one forward on the card."""
    args = train._parse(argv)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    batch = train.batch_to(train.host_data(cfg, args.seq, args.batch,
                                           args.seed).batch(0), cfg, dev)
    k = cfg.moe.experts_per_token
    ties = []
    route = layers._route

    def counted(x, router, k_):
        probs, gates, idx = route(x, router, k_)
        top = torch.topk(probs, k + 1, dim=-1).values
        ties.append(int((top[..., k - 1] - top[..., k] < TRAIN_TP_MOE_TIE)
                        .sum()))
        return probs, gates, idx
    layers._route = counted
    try:
        with torch.no_grad():
            transformer.forward(params, cfg, batch)
    finally:
        layers._route = route
    del params
    _free()
    return ties


def _train_tp_moe(dev: torch.device) -> dict:
    """(t11): ``launch/train.py --ranks 2 --model-ranks 2`` on
    deepseek-v2-lite at published widths cut to TRAIN_TP_MOE_LAYERS
    layers, over 2 gloo ranks sharing the card on the (1, 2) mesh, against
    the launcher's one-process run (the phase docstring's gates): MLA cut
    over its heads, the experts over the model group with the dispatch
    buffer and the experts' outputs exchanged by all-to-alls.  Returns
    the kernels' launches in the ranks, by counter."""
    t0 = time.perf_counter()
    _free()
    m = TRAIN_TP_RANKS
    steps = TRAIN_DANUBE["steps"]
    cfg = cut_depth(get_config(TRAIN_TP_MOE_ARCH), TRAIN_TP_MOE_LAYERS)
    argv = ["--batch", str(TRAIN_DANUBE["batch"]), "--seq",
            str(TRAIN_DANUBE["seq"]), "--steps", str(steps), "--lr",
            str(TRAIN_DANUBE["lr"]), "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_moe_") as tmp:
        blocks = os.path.join(tmp, "rank{rank}.pt")
        res, _ = train.over_ranks(
            argv + ["--ranks", str(m), "--model-ranks", str(m),
                    "--dist-backend", "gloo"],
            measure=True, cfg=dataclasses.asdict(cfg), params_out=blocks)
        check(res.returncode == 0, f"(t11) the run over ranks failed: "
              f"{res.failed}")
        t1 = time.perf_counter()
        docs = res.docs
        with contextlib.redirect_stdout(io.StringIO()):
            one = train.run(argv, cfg=dataclasses.asdict(cfg),
                            params_out=os.path.join(tmp, "one.pt"))
        t11 = time.perf_counter()
        gap, n_leaves, _ = _blocks_against_one(
            [blocks.format(rank=r) for r in range(m)], docs[0]["cuts"],
            torch.load(os.path.join(tmp, "one.pt"), mmap=True))
    t2 = time.perf_counter()
    ties = _near_ties(cfg, argv, dev)
    t21 = time.perf_counter()
    report = _reckon_fsdp(cfg, 1, False, model=m)
    whole_peak = _reckon_fsdp(cfg, 1, False)["memory_analysis"][
        "peak_size_bytes"]
    t3 = time.perf_counter()
    errs = [abs(a - b) / abs(b) for a, b in zip(docs[0]["losses"],
                                                 one["losses"])]
    kinds_ok, held = _kinds_held(report, docs, steps, m)
    bytes_ok = kinds_ok and all(
        report[key] > 0 for key in (
            "model_all_reduce_bytes", "moe_all_to_all_bytes",
            "moe_all_gather_bytes", "moe_stats_all_reduce_bytes",
            "partial_gradient_all_reduce_bytes"))
    same = all(d["digests"] == docs[0]["digests"] for d in docs) \
        and len(docs[0]["digests"]) == steps
    same_gnorm = all(d["gnorms"] == docs[0]["gnorms"] for d in docs)
    peak = report["memory_analysis"]["peak_size_bytes"]
    mem_errs = [abs(d["peak_bytes"] - peak) / peak for d in docs]
    launches = {name: sum(d["kernel_launches"][name] for d in docs)
                for name in LAUNCH_COUNTERS}
    d0 = docs[0]
    step_ms = [round(1e3 * x, 1) for x in d0["step_s"]]
    kinds = [k for k in d0["model_bytes"] if d0["model_calls"][k]]
    per_kind = "; ".join(
        f"{k} {d0['model_bytes'][k] // steps} B in "
        f"{d0['model_calls'][k] // steps} calls, s "
        f"{[round(x[k], 3) for x in d0['model_s']]} (share "
        f"{[round(x[k] / s, 3) for x, s in zip(d0['model_s'], d0['step_s'])]})"
        for k in kinds)
    n_tokens = TRAIN_DANUBE["batch"] * TRAIN_DANUBE["seq"]
    print(f"[train] (t11) {cfg.name} at published widths, "
          f"{TRAIN_TP_MOE_LAYERS} layers ({cfg.moe.n_experts} experts top-"
          f"{cfg.moe.experts_per_token}, {cfg.moe.n_shared_experts} shared,"
          f" MLA {cfg.n_heads} heads; remat {cfg.remat}), over {m} gloo "
          f"ranks sharing {dev} with MLA's heads, the experts and the "
          f"shared experts cut over the model axis across them "
          f"(launch/train.py --ranks {m} --model-ranks {m}, the (1, {m}) "
          f"mesh; experts {cfg.moe.n_experts} -> "
          f"{cfg.moe.n_experts // m} a rank, heads {cfg.n_heads} -> "
          f"{cfg.n_heads // m}), global batch {TRAIN_DANUBE['batch']} x "
          f"{TRAIN_DANUBE['seq']}, {steps} steps at lr "
          f"{TRAIN_DANUBE['lr']}: losses "
          f"{[round(x, 5) for x in d0['losses']]} against one process "
          f"{[round(x, 5) for x in one['losses']]} (worst "
          f"{max(errs):.2e} rel, gate {TRAIN_RANKS_LOSS_TOL}); the ranks' "
          f"blocks put together against its parameters, worst leaf "
          f"{gap:.2e} normwise over {n_leaves} leaves (gate "
          f"{TRAIN_FSDP_PARAM_TOL}; no token left out: near-tied routing "
          f"(margin < {TRAIN_TP_MOE_TIE}) at the first step, by MoE layer, "
          f"{ties} of {n_tokens} tokens); the whole leaves the same bits "
          f"on every rank after every step: {same}; clip norms "
          f"{[round(g, 4) for g in d0['gnorms']]}, the same on every rank: "
          f"{same_gnorm}; a step a rank, each kind against the dry-run's "
          f"entries of that kind on (1, {m}) by its relation: {held}: "
          f"equal {bytes_ok}; {per_kind}; "
          f"ms a step (synchronized) {step_ms}; peak "
          f"{[round(d['peak_bytes'] / 2**30, 3) for d in docs]} GiB a rank "
          f"against the reckoned per-device peak on (1, {m}) "
          f"{peak / 2**30:.3f} GiB "
          f"({', '.join(f'{100 * e:.2f} %' for e in mem_errs)}) and "
          f"{whole_peak / 2**30:.3f} GiB on (1, 1); kernel launches in the "
          f"ranks {launches}; ranks {res.wall_s:.1f} s with their starts "
          f"(each rank's run {[round(d['run_s'], 1) for d in docs]} s, its "
          f"set-up {[round(d['setup_s'], 1) for d in docs]} s), the "
          f"one-process run {t11 - t1:.1f} s, the blocks' comparison "
          f"{t2 - t11:.1f} s, the near ties {t21 - t2:.1f} s, the two "
          f"reckonings {t3 - t21:.1f} s; {time.perf_counter() - t0:.1f}s")
    check(max(errs) <= TRAIN_RANKS_LOSS_TOL, f"(t11) a loss over ranks is "
          f"{max(errs):.2e} from the one-process step's")
    check(gap <= TRAIN_FSDP_PARAM_TOL, f"(t11) the ranks' blocks lie "
          f"{gap:.2e} from the one-process parameters")
    check(same and same_gnorm, "(t11) the ranks' whole leaves or clip "
          "norms differ")
    check(bytes_ok, "(t11) a collective kind's bytes or calls differ from "
          "the dry-run's entries of that kind")
    check(max(mem_errs) <= DRYRUN_MEM_TOL, f"(t11) a rank's peak is "
          f"{100 * max(mem_errs):.1f} % from the reckoned per-device peak")
    check(not any(launches.values()), "(t11) a kernel launched in a rank")
    return launches


def _train_tp_ssm(dev: torch.device, tag: str, arch: str,
                  n_blocks: int) -> dict:
    """(t12) / (t13): ``launch/train.py --ranks 2 --model-ranks 2`` on
    ``arch`` at published widths cut to ``n_blocks`` blocks, over 2 gloo
    ranks sharing the card on the (1, 2) mesh, against the launcher's
    one-process run, held to (t10)'s gates, Mamba2's norm statistics'
    all-reduces against the dry-run's ``mamba/norm`` entries too.
    Returns the kernels' launches in the ranks, by counter."""
    t0 = time.perf_counter()
    _free()
    m = TRAIN_TP_RANKS
    steps = TRAIN_DANUBE["steps"]
    cfg = cut_depth(get_config(arch), n_blocks)
    argv = ["--batch", str(TRAIN_DANUBE["batch"]), "--seq",
            str(TRAIN_DANUBE["seq"]), "--steps", str(steps), "--lr",
            str(TRAIN_DANUBE["lr"]), "--log-every", "1"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_ssm_") as tmp:
        blocks = os.path.join(tmp, "rank{rank}.pt")
        res, _ = train.over_ranks(
            argv + ["--ranks", str(m), "--model-ranks", str(m),
                    "--dist-backend", "gloo"],
            measure=True, cfg=dataclasses.asdict(cfg), params_out=blocks)
        check(res.returncode == 0, f"({tag}) the run over ranks failed: "
              f"{res.failed}")
        t1 = time.perf_counter()
        docs = res.docs
        with contextlib.redirect_stdout(io.StringIO()):
            one = train.run(argv, cfg=dataclasses.asdict(cfg),
                            params_out=os.path.join(tmp, "one.pt"))
        t11 = time.perf_counter()
        zero = {path for path, leaf in leaves_with_paths(
            transformer.param_specs(cfg)) if leaf.init == ("full", 0.0)}
        gap, n_leaves, zero_gaps = _blocks_against_one(
            [blocks.format(rank=r) for r in range(m)], docs[0]["cuts"],
            torch.load(os.path.join(tmp, "one.pt"), mmap=True), zero)
    t2 = time.perf_counter()
    report = _reckon_fsdp(cfg, 1, False, model=m)
    t3 = time.perf_counter()
    zero_gap = max(zero_gaps.values(), default=0.0)
    errs = [abs(a - b) / abs(b) for a, b in zip(docs[0]["losses"],
                                                 one["losses"])]
    mamba = "mamba2" in cfg.blocks()
    kinds_ok, held = _kinds_held(report, docs, steps, m)
    bytes_ok = kinds_ok and report["model_all_reduce_bytes"] > 0 \
        and (report["norm_all_reduce_bytes"] > 0) == mamba \
        and report["partial_gradient_all_reduce_bytes"] > 0
    same = all(d["digests"] == docs[0]["digests"] for d in docs) \
        and len(docs[0]["digests"]) == steps
    same_gnorm = all(d["gnorms"] == docs[0]["gnorms"] for d in docs)
    peak = report["memory_analysis"]["peak_size_bytes"]
    mem_errs = [abs(d["peak_bytes"] - peak) / peak for d in docs]
    launches = {name: sum(d["kernel_launches"][name] for d in docs)
                for name in LAUNCH_COUNTERS}
    d0 = docs[0]
    step_ms = [round(1e3 * x, 1) for x in d0["step_s"]]
    kinds = [k for k in d0["model_bytes"] if d0["model_calls"][k]]
    per_kind = "; ".join(
        f"{k} {d0['model_bytes'][k] // steps} B in "
        f"{d0['model_calls'][k] // steps} calls, s "
        f"{[round(x[k], 3) for x in d0['model_s']]} (share "
        f"{[round(x[k] / s, 3) for x, s in zip(d0['model_s'], d0['step_s'])]})"
        for k in kinds)
    print(f"[train] ({tag}) {cfg.name} at published widths, {n_blocks} "
          f"blocks {cfg.block_pattern} (remat {cfg.remat}), over {m} gloo "
          f"ranks sharing {dev}, the (1, {m}) mesh (launch/train.py --ranks "
          f"{m} --model-ranks {m}), global batch {TRAIN_DANUBE['batch']} x "
          f"{TRAIN_DANUBE['seq']}, {steps} steps at lr {TRAIN_DANUBE['lr']}"
          f": losses {[round(x, 5) for x in d0['losses']]} against one "
          f"process {[round(x, 5) for x in one['losses']]} (worst "
          f"{max(errs):.2e} rel, gate {TRAIN_RANKS_LOSS_TOL}); blocks put "
          f"together, worst leaf {gap:.2e} normwise over {n_leaves} leaves "
          f"(gate {TRAIN_FSDP_PARAM_TOL}), the {len(zero_gaps)} set to zero "
          f"at the start {zero_gap:.2e} (of their updates, gate "
          f"{TRAIN_TP_UPDATE_TOL}); whole leaves the same bits: "
          f"{same}; clip norms {[round(g, 4) for g in d0['gnorms']]}, the "
          f"same on every rank: {same_gnorm}; a step a rank, each kind "
          f"against the dry-run's entries of that kind on (1, {m}) by its "
          f"relation: {held}: equal {bytes_ok}; "
          f"{per_kind}; ms a step (synchronized) {step_ms}; peak "
          f"{[round(d['peak_bytes'] / 2**30, 3) for d in docs]} GiB a rank "
          f"against the reckoned {peak / 2**30:.3f} GiB "
          f"({', '.join(f'{100 * e:.2f} %' for e in mem_errs)}); kernel "
          f"launches in the ranks {launches}; ranks {res.wall_s:.1f} s "
          f"(runs {[round(d['run_s'], 1) for d in docs]} s), one process "
          f"{t11 - t1:.1f} s, comparison {t2 - t11:.1f} s, reckoning "
          f"{t3 - t2:.1f} s; {time.perf_counter() - t0:.1f}s")
    check(max(errs) <= TRAIN_RANKS_LOSS_TOL, f"({tag}) a loss over ranks is "
          f"{max(errs):.2e} from the one-process step's")
    check(gap <= TRAIN_FSDP_PARAM_TOL and zero_gap <= TRAIN_TP_UPDATE_TOL,
          f"({tag}) the ranks' blocks lie {gap:.2e} ({zero_gap:.2e} where "
          f"set to zero at the start) from the one-process parameters")
    check(same and same_gnorm, f"({tag}) the ranks' whole leaves or clip "
          "norms differ")
    check(bytes_ok, f"({tag}) a collective kind's bytes or calls differ "
          "from the dry-run's entries of that kind")
    check(max(mem_errs) <= DRYRUN_MEM_TOL, f"({tag}) a rank's peak is "
          f"{100 * max(mem_errs):.1f} % from the reckoned per-device peak")
    check(not any(launches.values()), f"({tag}) a kernel launched in a rank")
    return launches


def _counted_step(dev: torch.device, fn) -> dict:
    """One call of ``fn`` (a model step) on the card under
    ``FlopCounterMode``, the peak statistics reset before it: the
    products' FLOPs, the bytes allocated before it and at its peak, and
    its output."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    flops = FlopCounterMode(display=False)
    with flops:
        out = fn()
    torch.cuda.synchronize(dev)
    return {"flops": flops.get_total_flops(), "allocated": before,
            "peak": torch.cuda.max_memory_allocated(dev), "out": out}


def phase_dryrun(dev: torch.device, d1: dict, d2: dict) -> None:
    """launch/dryrun.py's reckoning held against real steps: (d1) [train]
    (t3)'s danube step and (d2) [serve] (a)'s qwen2-72b decode step,
    each reckoned on meta over a (1, 1) mesh of the card, against one
    extra step of that phase counted on the card: the same FLOPs; the
    reckoned peak within DRYRUN_MEM_TOL of the step's
    max_memory_allocated, and the traced peak beside the arguments (the
    temps and the new outputs) within DRYRUN_RISE_TOL of the card's rise
    from the step's start to its peak; the three terms (the memory term
    is the eager step's own op traffic) beside the measured step and the
    hand-written bound.  Then (d3) one production cell through the
    command line.  No kernel runs."""
    _zero_counts()
    mesh = Mesh((1, 1), ("data", "model"), [dev])
    for tag, real in (("d1", d1), ("d2", d2)):
        t0 = time.perf_counter()
        cfg, shape = real["cfg"], real["shape"]
        r = dryrun.reckon(cfg, shape, mesh, optimizer=real["optimizer"])
        mem = r["memory_analysis"]
        args, peak = mem["argument_size_bytes"], mem["peak_size_bytes"]
        err = abs(peak - real["peak"]) / real["peak"]
        rise = real["peak"] - real["allocated"]
        rise_err = abs(peak - args - rise) / rise
        bound = r["step_time_lower_bound_s"] * 1e3
        print(f"[dryrun] ({tag}) {real['where']} {cfg.name} "
              f"{len(cfg.blocks())} blocks {cfg.dtype}, {shape.kind} batch "
              f"{shape.global_batch} x seq {shape.seq_len}: FLOPs traced on "
              f"meta {r['hlo_flops']:.0f}, counted on the card "
              f"{real['flops']}, equal {r['hlo_flops'] == real['flops']}; "
              f"argument {args} B + traced peak beside it {peak - args} B "
              f"(temp without the outputs {mem['temp_size_bytes']} B) = "
              f"{peak / 2**30:.3f} GiB reckoned against "
              f"max_memory_allocated {real['peak'] / 2**30:.3f} GiB "
              f"({100 * err:.2f} %); the card's rise from the step's start "
              f"(allocated {real['allocated']} B) to its peak {rise} B "
              f"({100 * rise_err:.3f} % from the traced peak); bytes "
              f"accessed (the eager step's op traffic) "
              f"{r['hlo_bytes_accessed'] / 1e9:.3f} GB; compute "
              f"{r['compute_s'] * 1e3:.3f} ms, memory "
              f"{r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}: "
              f"bound {bound:.3f} ms against {real['ms']:.3f} ms measured "
              f"a step ({bound / real['ms']:.3f}); "
              f"hand-written bound {real['hand_bound_ms']:.2f} ms, "
              f"{real['ms'] / real['hand_bound_ms']:.2f}x; "
              f"{r['traced_ops']} ops traced in {r['compile_s']}s; "
              f"{time.perf_counter() - t0:.1f}s")
        check(r["hlo_flops"] == real["flops"], f"({tag}) the meta trace's "
              f"FLOPs differ from the card's")
        check(err <= DRYRUN_MEM_TOL, f"({tag}) the reckoned peak is "
              f"{100 * err:.1f} % from the card's")
        check(rise_err <= DRYRUN_RISE_TOL, f"({tag}) the traced peak beside "
              f"the arguments is {100 * rise_err:.2f} % from the card's rise")

    # (d3) one production cell through the command line
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        run = child.run("repro_torch.launch.dryrun", [
            "--arch", "h2o-danube-3-4b", "--shape", "train_4k", "--mesh",
            "pod", "--out", tmp], env, timeout=300)
        path = os.path.join(tmp, "h2o-danube-3-4b__train_4k__16x16.json")
        report = {}
        if run.returncode == 0 and os.path.exists(path):
            with open(path) as f:
                report = json.load(f)
    print(f"[dryrun] (d3) --arch h2o-danube-3-4b --shape train_4k --mesh "
          f"pod: exit {run.returncode}; "
          + (f"{report['hlo_flops']:.4e} FLOPs a device, compute "
             f"{report['compute_s']:.4f} s, memory {report['memory_s']:.4f}"
             f" s, collective {report['collective_s']:.4f} s, dominant "
             f"{report['dominant']}, roofline_fraction "
             f"{report['roofline_fraction']:.4f}; "
             if report else "no report; ")
          + f"{time.perf_counter() - t0:.1f}s")
    check(bool(report), f"the production dry-run cell failed: "
          f"{run.stdout[-1000:]} {run.stderr[-2000:]}")
    check(not any(_counts().values()), "a kernel launched in [dryrun]")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    if sys.argv[1:] == ["--fsdp-probe"]:
        phase_card(dev)
        child.warm()
        _train_fsdp(dev, get_config("h2o-danube-3-4b").n_layers, probe=True)
        child.stop()
        print(f"[done] {time.perf_counter() - t0:.1f}s")
        return
    if sys.argv[1:] == ["--tp-moe-probe"]:
        phase_card(dev)
        child.warm()
        _train_tp_moe(dev)
        child.stop()
        print(f"[done] {time.perf_counter() - t0:.1f}s")
        return
    if sys.argv[1:] == ["--pod-lm-probe"]:
        phase_card(dev)
        phase_build()
        child.warm()
        _pod_lm_points(dev, "rwkv6-7b")
        _pod_lm_grid(dev, "rwkv6-7b")
        child.stop()
        print(f"[done] {time.perf_counter() - t0:.1f}s")
        return
    if sys.argv[1:] == ["--serve-tp-probe"]:
        phase_card(dev)
        phase_build()
        child.warm()
        cfg, params = _serve_model(
            "h2o-danube-3-4b", "bfloat16",
            torch.Generator(device=dev).manual_seed(SERVE_TP["seed"]), dev)
        _serve_tp(dev, cfg, params)
        child.stop()
        print(f"[done] {time.perf_counter() - t0:.1f}s")
        return
    if sys.argv[1:] == ["--tp-ssm-probe"]:
        phase_card(dev)
        child.warm()
        for leg in TRAIN_TP_SSM:
            _train_tp_ssm(dev, *leg)
        child.stop()
        print(f"[done] {time.perf_counter() - t0:.1f}s")
        return

    def timed(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        print(f"[wall] {name} {time.perf_counter() - t:.1f}s")
        return result

    timed("card", phase_card, dev)
    timed("build", phase_build)
    gram = timed("gram", phase_gram, dev)
    row_mean = timed("rowmean", phase_rowmean, dev)
    timed("fitness", phase_fitness, dev)
    launches = timed("fig2", phase_fig2, dev)   # the main path, from 0
    # the forkserver of the child processes ([server], [obs], [train],
    # [dryrun]) imports torch and the port beside the phases before them
    child.warm()
    baselines_launches = timed("baselines", phase_baselines, dev)
    timed("fig3", phase_fig3, dev)
    timed("grid", phase_grid, dev)
    row_mean_launches, children, server_doc, server_wall = timed(
        "server", phase_server, dev)
    pod_ranks = timed("pod", phase_pod, dev)
    children += timed("obs", phase_obs, dev, server_doc, server_wall)
    timed("portfolio", phase_portfolio, dev)
    examples_launches = timed("examples", phase_examples, dev)
    flash = timed("flash", phase_flash, dev)
    wkv6 = timed("wkv6", phase_wkv6, dev)
    flash_launches, lm = timed("lm danube", phase_lm, dev,
                               "h2o-danube-3-4b", flash["ms"])
    flash_ranks = timed("pod lm danube", phase_pod_lm, dev,
                        "h2o-danube-3-4b", lm)
    wkv6_launches, lm = timed("lm rwkv6", phase_lm, dev, "rwkv6-7b",
                              wkv6["ms"])
    wkv6_ranks = timed("pod lm rwkv6", phase_pod_lm, dev, "rwkv6-7b", lm)
    flash_subspace = timed("subspace lm danube", phase_subspace_lm, dev,
                           "h2o-danube-3-4b")
    wkv6_subspace = timed("subspace lm rwkv6", phase_subspace_lm, dev,
                          "rwkv6-7b")
    serve_launches, d2 = timed("serve", phase_serve, dev)
    serve_moe_launches = timed("serve moe", phase_serve_moe, dev)
    serve_hybrid_launches = timed("serve hybrid", phase_serve_hybrid, dev)
    d1, train_tp = timed("train", phase_train, dev)
    timed("dryrun", phase_dryrun, dev, d1, d2)
    child.stop()                    # no process left behind
    print(f"[done] {time.perf_counter() - t0:.1f}s")
    phase_card(dev)                 # the stamp again, near the end
    print(json.dumps({"kernels": [
        {"name": "gram", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram.py:44",
         "launches": launches,
         "ranks_launches": pod_ranks.get("gram_launches", 0),
         "train_tp_launches": train_tp["gram_launches"], **gram},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:81",
         "launches": flash_launches, "ranks_launches": flash_ranks,
         "serve_launches": serve_launches["flash_attention"],
         "serve_ranks_launches": serve_launches["flash_attention_ranks"],
         "serve_moe_launches": serve_moe_launches,
         "serve_hybrid_launches": serve_hybrid_launches,
         "subspace_launches": flash_subspace,
         "train_tp_launches": train_tp["flash_attention_launches"],
         **flash},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/wkv6.py:50",
         "launches": wkv6_launches, "ranks_launches": wkv6_ranks,
         "serve_launches": serve_launches["wkv6"],
         "subspace_launches": wkv6_subspace,
         "train_tp_launches": train_tp["wkv6_launches"], **wkv6},
        {"name": "row_mean", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/row_mean.cu",
         "replaces": "src/repro/data/sdss.py:79 (jnp.mean, :79, :80, :85; "
                     "no TPU kernel: port-only)",
         "launches": row_mean_launches,
         "ranks_launches": pod_ranks.get("row_mean_launches", 0),
         "baselines_launches": baselines_launches,
         "server_children_launches": children,
         "examples_launches": examples_launches,
         "train_tp_launches": train_tp["row_mean_launches"],
         **row_mean}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
