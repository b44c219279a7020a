#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (``/usr/local/cuda``); without a card, or outside the
repository, it exits non-zero and prints no result. Phases, any failure of
which exits non-zero:

1. Card and build: the card's name and power limit, then every kernel built
   from ``sheeprl_tpu_torch/csrc`` (build seconds and ptxas's report).
2. Kernel against plain: ``fused_recurrent_step`` against ``reference_step``
   at the Dreamer-V3 S shapes (B = 1, 4, 16 and the imagination batch 1024)
   and at M width, forward and gradients, then the device time of the kernel
   and of the plain version (CUDA-event time of a replayed CUDA graph, L2
   warm), the kernel's L2-cold time (a buffer of twice the L2 written before
   each call, its own time subtracted), each of its launches' device time
   per call (torch.profiler over the graph's replays), its launch plan and,
   apart, the time per call issued from Python.
3. The slice: the Dreamer-V3 S player (seeded init, 4 PixelCatcher envs)
   and one capped ``evaluate()`` episode, with the kernel launch count held
   to one per step; a torch.profiler window over 8 player steps (device busy
   time, idle share, the fused step's share of it, top kernels); then the
   same observations replayed through the fused and the plain
   (``fused="flax"``) players in mode/greedy, h compared.
4. The model-sharded step (``sharded_recurrent_step``): (a) its projection
   kernel ``sharded_proj`` against its plain version at one rank's shapes
   (S mp=1 fp32 B=4; L/4-way bf16 at B=16, 64, 256 and 1024; XL/16-way bf16
   at B=16 and B=1024), with the route the plan took (``splitk`` on the CUDA
   cores, ``tc16``/``tc64`` on the tensor cores), device, plain, library (one
   cuBLAS ``torch.mm``) and per-call host times beside the bound and the
   fp32-rate bound of earlier rows, and its max abs error at most 1e-5 at
   every shape; (b) the full-width step on a 1-rank NCCL mesh
   (file store in a temporary directory): S fp32 at B=4 and B=16 against
   ``fused_recurrent_step`` and ``reference_step``, XL with bf16 W2 at B=16
   against ``reference_step`` on the upcast W2, and the S gradients of all
   nine inputs against plain autograd, with the projection kernel launched
   once per step, on the tensor cores for the bf16 step; then the S steps again with ``use_pallas=False`` (the
   plain projection: no launch, the same h'), and the S B=4 step once more
   on one CUDA rank spawned by ``parallel.launch.run`` (its default device,
   NCCL), against the same h'. (a) holds the kernel at every projection
   shape (b) gives it: S mp=1 fp32 at B=4 and B=16, XL mp=1 bf16 at B=16.
6. Training at Dreamer-V3 S width (B=16 sequences of T=64, horizon 15, 4
   PixelCatcher envs, fp32): (a) one batch drawn from the port's replay,
   filled by PixelCatcher steps, through one ``make_train_step`` with the
   kernel (``fused: auto``) and one with the plain ``RecurrentModel``
   (``fused: flax``) from the same seeded weights, with deterministic
   samplers; the 13 metrics and the world-model gradients held within
   their printed bounds; (b) ``fused_gru`` launched 64 (scan, B=16) + 16
   (imagination, B=1024) times a step, and one continuous-action step (the
   dummy env) whose actor gradient runs back through B1 at B=1024; (c) ms
   per gradient step, fused and plain in turns, then a torch.profiler
   window over each (idle share, B1's share and time per call at B=16 and
   B=1024, device and host time of each RSSM step, top kernels); (d)
   ``main()`` for a few hundred env steps with the cuts printed, its
   env-steps/s and gradient steps/s, the kernel's launches counted (each
   gradient step is a replay of the captured step: the wrapper's calls
   outside capture, plus the 80 calls captured times the replays).
7. The captured train step (``ops/graph.py``, as ``main`` builds it): (a)
   three replays against three eager steps from the same weights and
   batches, discrete (PixelCatcher) and continuous (the dummy env), smooth
   samplers and cuDNN's deterministic algorithms: metrics, parameters and
   Moments within ``REPLAY_BOUND``, Adam's count 3, 80 kernel calls
   captured; (b) with the real samplers, a replay after the generator moved
   on differs from the first, and re-setting the generator reproduces it;
   (c) ms per gradient step replayed and eager, with B1 and with the plain
   recurrent model (CUDA events), and torch.profiler over replays: device
   busy and idle share, ``gru_step`` kernels a replayed step (2 x 80); (d)
   ``main()`` with a checkpoint every 64 policy steps and a forced NaN (one
   rollback to the newest committed checkpoint), then a second ``main()``
   resuming from it (``checkpoint.resume_from=auto``) to its end.
8. The default precision, ``bf16-mixed`` (fp32 parameters, bf16 compute;
   phases 3, 6 and 7 pin ``fabric.precision: 32-true``): (a) B1 reading a
   bf16 x at S B=4, 16 and 1024 against ``reference_step`` on the same x
   (forward 1e-5, gradients 1e-4, dx in bf16), with its device time beside
   the fp32-x time and the bound with x at 2 bytes; (b) one eager S step
   with B1 against the plain recurrent model at bf16 and against the fp32
   B1 step (metrics and gradients within their printed bounds), 80 B1
   calls a step, each with a bf16 x; (c) replayed against eager as 7(a);
   (d) ms per replayed step, B1 and plain, bf16 and fp32, in turns, and a
   profiler window over each bf16 step (idle share, top kernels, B1's
   share); (e) ``main()``'s short loop: env-steps/s and gradient steps/s;
   (f) the S player: ms a step and env-steps/s. Alone on the card:
   ``python -c 'import chip_smoke as c, numpy as np, torch; from
   sheeprl_tpu_torch.ops import fused_gru as fg; c.phase_bf16_kernel(torch,
   fg, c.BF16_KERNEL_SHAPES); rb, s, a, k = c.filled_replay(np,
   c.train_cfg("pixel_catcher"), 80); c.phase_bf16_train(torch, np, fg, rb,
   s, a, k)'`` (and ``phase_bf16_timing``, ``phase_bf16_player`` alike).
9. Replay where the JAX package keeps it, at bf16-mixed: (a) the ring
   (``data/device_buffer.py``): ``buffer.device=auto`` picks it at the
   Atari-100k shape (buffer.size 100000, 1 env, 64x64x3), its bytes within
   1% of the estimate; a ring and a host buffer fed the same steps gather
   the same windows bit for bit; 10^4 in-graph draws start only where the
   host allows, each env's share within 3 sigma of uniform; (b) a superstep
   of K = 4 steps over pregathered batches (``ops/superstep.py``) against
   four replays of the per-step graph with the host EMA: metrics,
   parameters, target critic, Adam state and Moments within
   ``REPLAY_BOUND`` (bit for bit reported), 4 x 160 ``gru_step`` kernels a
   superstep replay in the profiler; (c) ms per gradient step (in turns),
   the device's idle share, host-to-device bytes and peak memory of four
   replay paths: host buffer and ring, K = 0 and K = 4 (and the K = 1
   ring's peak memory; each profiled over 2 gradient steps, K = 4 over 4); (d)
   ``main()`` at 8(e)'s cuts with buffer.size 100000 and 288 env steps: the
   memmapped host buffer, the ring per step, the ring with
   K = 4 (env-steps/s, gradient steps/s, the kernel's launches), then the
   drill: the ring checkpointed with ``buffer.checkpoint``, its contents
   restored into a memmapped host buffer and back, and ``main()`` resumed
   on the host buffer and from there on the ring. Alone on the card:
   ``python -c 'import chip_smoke as c, numpy as np, torch, tempfile; from
   sheeprl_tpu_torch.ops import fused_gru as fg; c.phase_ring(torch, np);
   rb, s, a, k = c.filled_replay(np, c.train_cfg("pixel_catcher"), 80);
   c.phase_superstep_parity(torch, np, rb, s, a, k);
   c.phase_replay_paths(torch, np, rb, s, a, k); d = tempfile.mkdtemp();
   c.phase_ring_loops(torch, np, fg, d); c.phase_ring_drill(torch, np, d)'``.
10. The entry point, ``python -m sheeprl_tpu_torch``, at 8(e)'s cuts
   (``CLI_CUTS``: S width, bf16-mixed, the ring, a log window every 64 env
   steps, a checkpoint every 128 with the ring in it), each command in a
   temporary cwd with its logs and run registry under a temporary
   directory: (a) ``exp=dreamer_v3 env=pixel_catcher
   metric.telemetry.enabled=True`` in a subprocess (exit 0, ``config.yaml``,
   an event file the port's reader decodes with every train metric and
   ``Time/sps_*`` at each window after learning starts and rewards where
   episodes ended, all finite, heartbeats naming the card with a device
   memory peak and 0 < MFU <= 1, one ``completed`` record), then the same
   argv in this process through ``cli.run`` for the kernel's launches; (b)
   ``python -m sheeprl_tpu_torch.cli_eval`` on (a)'s last checkpoint, one
   episode capped at ``EVAL_CAP`` steps, and its eval record; (c) the CLI
   resuming (a)'s mid-run checkpoint with ``fabric.precision=32-true`` on
   the command line: the stored config with that override, trained to the
   end; (d) env-steps/s of the in-process run with telemetry on and off
   beside 8(e)'s loop, FLOPs a gradient step and the heartbeat's MFU, with
   the card's name and power limit. Alone on the card: ``python -c 'import
   chip_smoke as c, numpy as np, torch, tempfile; from sheeprl_tpu_torch.ops
   import fused_gru as fg; fg.load_library(); n, r = c.phase_train_loop(torch,
   np, fg, tempfile.mkdtemp(), c.BF16, "bf16_train_loop");
   c.phase_cli(torch, np, fg, tempfile.mkdtemp(), r)'``.
11. The env pipeline (``envs/``), in this process: (a) ``find_spec`` of
   gymnasium and cv2 printed; the PixelPendulum and PixelPointmass specs
   over 256 envs on the card against the same specs on the CPU,
   teacher-forced from the CPU states for 50 steps (states, rewards and
   flags within 1e-6, frames equal but for mask-edge pixels, counted), and
   ``ImageTransform`` 128 -> 64 with grayscale against plain numpy, bit for
   bit; host ms per vector-env step, ``sync`` and ``async`` at 4 envs; (b)
   ``exp=dreamer_v3 env=pixel_pendulum env.action_repeat=2
   env.backend=async`` at 8(e)'s cuts through ``cli.run``, then the same on
   ``sync``: env-steps/s (the heartbeat's env steps 2 x policy steps), the
   spans' seconds, gradient steps/s, B1
   launches all with a bf16 x, the test episode's reward (100 steps), and
   ``config.yaml`` holding no float without a ``.``; (c) ``env=pixel_pointmass
   env.wrapper.size=128 env.grayscale=True env.backend=sync`` with an env
   that raises once (``FlakyPixelEnv``) on the ring: the encoder reads
   [1, 64, 64], one restart, ``amend_last`` rewrites that env's last step
   to truncated 1, terminated 0, is_first 0 and the next step reads
   is_first 1. Alone on the card: ``python -c 'import chip_smoke as c,
   numpy as np, torch, tempfile; from sheeprl_tpu_torch.ops import fused_gru
   as fg; fg.load_library(); c.phase_env_pipeline(torch, np, fg,
   tempfile.mkdtemp())'``.
12. PPO and Dreamer-V3 at ``bf16-true`` (bf16-mixed unless named): (a)
   the PPO update (GAE, then epochs x minibatches of forward, backward and
   Adam) captured as one CUDA graph against the same update eager on the
   card, from the same weights and train generator, at ``exp=ppo`` widths
   and at ``exp=ppo_atari``'s NatureCNN on PixelCatcher: parameters after
   three updates within ``PPO_UPDATE_BOUND``, ms an update replayed and
   eager, one capture, and a profiler window over two replays (device busy
   time, idle share, kernels a replay, top kernels); (b) ``exp=ppo`` through ``cli.run`` (the port's
   host CartPole-v1, ``sync``, 4 envs) for ``PPO_CLI_UPDATES`` updates;
   (c) the same with ``algo.fused_rollout=True`` at 4 envs and at 64 envs
   with batch 1024: one replay an update, no ``fused_fallback``; (d)
   NatureCNN on PixelCatcher (8 envs, ``sync``): env-steps/s (overall and
   steady, the first update capturing), ms an update, the env span's share
   and the test episode of each; (e) one Dreamer-V3 S step at ``bf16-true``
   bit-equal to the step at ``bf16-mixed`` (fp32 parameters at both, as
   the JAX modules fix them), B1 called 80 times a step with a bf16 x.
   PPO reaches no TPU kernel, so no kernel is added; its numbers ride in
   the kernels line under ``fused_gru``'s ``ppo``. Alone on the card:
   ``python -c 'import chip_smoke as c, numpy as np, torch, tempfile; from
   sheeprl_tpu_torch.ops import fused_gru as fg; fg.load_library();
   c.phase_ppo_update(torch, np); c.phase_ppo_cli(torch, tempfile.mkdtemp());
   rb, s, a, k = c.filled_replay(np, c.train_cfg("pixel_catcher"), 80);
   c.phase_bf16_true(torch, np, fg, rb, s, a, k)'``.
13. A2C and recurrent PPO (bf16-mixed): (a) the A2C update (GAE and one
   RMSProp step over the 5 x 4 rollout) captured against eager at
   ``exp=a2c`` widths: parameters and RMSProp's ``nu`` after three updates
   within ``PPO_UPDATE_BOUND`` (bit-equality reported), ms an update
   replayed and eager, one capture; (b) ``exp=a2c`` through ``cli.run`` on
   the host CartPole-v1 loop (``sync``, 4 envs) for ``A2C_CLI_UPDATES``
   updates, then with ``algo.fused_rollout=True`` (one replay an update, no
   ``fused_fallback``): env-steps/s overall and steady, the test episode;
   (c) the recurrent update at ``exp=ppo_recurrent`` widths (LSTM 64, 16
   envs x 512 steps, sequences of 16, 8 minibatches, 8 epochs) on one
   seeded rollout, the host path's padded chunks and the fused path's
   fixed windows with resets, each captured against eager within
   ``PPO_UPDATE_BOUND``, ms an update replayed and eager, a profiler window
   over two replays; the player's LSTM step (its CUDA graph) against the
   same step on the CPU for 64 steps, teacher-forced, within 1e-5 at fp32;
   (d) ``exp=ppo_recurrent`` through ``cli.run`` on the host loop, cut to
   ``RPPO_CLI_UPDATES`` updates of 8192 env steps (the cuts printed):
   env-steps/s overall and steady, ms an update, the captures made (one for
   each padded sequence count), the env span's share; then the fused
   rollout, one replay an update, no ``fused_fallback``. Neither algorithm
   reaches a TPU kernel: the phase checks that B1 and B2 were not launched,
   and their numbers ride in the kernels line under ``fused_gru``'s
   ``a2c`` and ``ppo_recurrent``. Alone on the card: ``python -c 'import
   chip_smoke as c, numpy as np, torch, tempfile;
   c.phase_a2c_update(torch, np); c.phase_a2c_cli(torch, tempfile.mkdtemp());
   c.phase_rppo_update(torch, np); c.phase_rppo_cli(torch,
   tempfile.mkdtemp())'``.
14. SAC, DroQ and SAC-AE (bf16-mixed): (a) one update of each at full
   published width on one seeded batch, captured against the same update
   run eagerly on the card from the same weights and generators: SAC a
   chunk of 16 gradient steps (256 hidden, 2 critics, batch 256), DroQ
   G = 20 (a chunk of 16, four one-step replays, the actor update), SAC-AE
   two steps, one of each gate phase (512-channel convs on 9 x 64 x 64
   frames, hidden 1024, batch 128); every parameter and optimizer state
   within ``SAC_UPDATE_BOUND`` of eager (bit-equality reported), ms a
   replay, a profiler window (kernels a replay, busy ms, idle share) and
   SAC-AE's FLOPs a gradient step and MFU; (b) ``exp=sac`` and
   ``exp=droq`` through ``cli.run`` on 4 Pendulum-v1 envs and
   ``exp=sac_ae`` on 4 PixelPendulum envs with a frame stack of 3, each on
   the ring and on the host buffer, and SAC with
   ``algo.fused_gradient_steps=4`` on the ring (the cuts printed):
   env-steps/s overall and steady, captures, host-to-device bytes a
   gradient step, the test episode, no ``fused_fallback``; ``buffer.device:
   auto`` picking the host buffer for SAC-AE at its published 1M
   transitions; (c) ``cli_eval`` on each algorithm's checkpoint of (b);
   (d) no B1 or B2 launch in the phase. The SAC family reaches no TPU
   kernel; its numbers ride in the kernels line under ``fused_gru``'s
   ``sac_family``. Alone on the card: ``python -c 'import chip_smoke as c,
   numpy as np, torch, tempfile; c.phase_sac_update(torch, np);
   c.phase_sac_cli(torch, np, tempfile.mkdtemp())'`` (TF32 off first).
15. The serving tier (``python -m sheeprl_tpu_torch serve``), over phase
   12's PPO checkpoints (the exp=ppo MLP on CartPole-v1 and the NatureCNN on
   PixelCatcher, bf16-mixed): (a) each model's ladder (``serve.batch_ladder``
   1, 2, 4, 8; one CUDA graph a rung for each of two replica slots): every
   rung's replay bit-equal to the same rung run eagerly and equal to the
   plain forward (the training player's greedy actions), ms a replay back
   to back (CUDA events), host ms a round trip, capture seconds a rung,
   host ms a request through ``ServeClient.infer`` at batch 1 (gather
   window 0 and default); (b) ``serve ckpt_dir=... serve.load.enabled=true``
   through ``cli.run``, a closed loop at concurrency 8, then an open loop at
   a fixed rate: QPS, p50/p95 against ``slo_ms``, ``slo_met``, mean batch,
   shed and retry counts, the ``kind: serve`` run record; (c) the drills:
   ``replica_crash`` at batch 5 (the requeued request served), a hot swap
   under load (nothing dropped, every answer equal to the plain forward of
   the version stamped on it), ``poison_swap`` rejected. Serving reaches no
   TPU kernel: the phase checks that B1 and B2 were not launched, and its
   numbers ride in the kernels line under ``fused_gru``'s ``serve``. Alone
   on the card (phase 12's runs first): ``python -c 'import chip_smoke as
   c, numpy as np, torch, tempfile; from sheeprl_tpu_torch.ops import
   fused_gru as fg; d = tempfile.mkdtemp(); c.phase_ppo_cli(torch, d);
   c.phase_serve(torch, np, fg, d)'`` (TF32 off first).
16. Plan2Explore on Dreamer-V3 (``algos/p2e_dv3``) at S widths (the keys
   of ``configs/algo/dreamer_v3_S.yaml`` over ``exp=p2e_dv3_exploration``),
   bf16-mixed, on PixelCatcher: (a) the exploration step (world model, 8
   ensemble members, two imaginations, five actor and critic updates) on
   phase 6's replay, B=16, T=64, horizon 15, the smooth samplers: three
   replays of its CUDA graph against three eager steps within
   ``REPLAY_BOUND``, one eager B1 step against the plain model within
   ``P2E_METRIC_BOUND``/``P2E_GRAD_BOUND`` (tests/test_torch_precision.py's
   train-step bounds), B1 called 96 times a step (64 at B=16, 2 x 16 at
   B=1024); ms a replay and a profiler window (192 ``gru_step`` kernels a
   replay, idle share, top kernels); (b) ``exp=p2e_dv3_exploration``
   through ``cli.run`` cut to ``P2E_CUTS``, ending with its checkpoint,
   ``exp=p2e_dv3_finetuning`` from it, cut alike (the policy step at which
   its player switched from the exploration actor to the task actor), then
   ``cli_eval`` on the finetuning checkpoint: env-steps/s, B1's launches of
   each (in the kernels line under ``fused_gru``'s ``p2e_dv3``), every
   one counted reading a bf16 ``x``, the run records. Alone on the card: ``python -c 'import chip_smoke as c, numpy
   as np, torch, tempfile; from sheeprl_tpu_torch.ops import fused_gru as
   fg; fg.load_library(); rb, s, a, k = c.filled_replay(np,
   c.train_cfg("pixel_catcher"), 80); c.phase_p2e_step(torch, np, fg, rb,
   s, a, k); c.phase_p2e_cli(torch, np, fg, tempfile.mkdtemp())'`` (TF32
   off first).
17. Placement, PPO's overlapped collection and Dreamer-V2, bf16-mixed:
   (a) ``dispatch_roundtrip_seconds()`` and what ``auto`` resolves to for
   the player and for PPO's update (the card); ``exp=ppo`` (CartPole-v1,
   the MLP) with ``algo.player_device=cpu``, then ``algo.train_device=cpu``,
   and ``exp=dreamer_v3`` at S on PixelCatcher with the player on the host
   for two train windows: env-steps/s and each run's devices, B1 launched by
   the learner only (the host player's calls counted apart: none), the
   player's copy bit-equal to the learner's after the flush before the
   test; (b) ``exp=ppo``'s host loop with ``algo.overlap_collection`` off
   and on, the same seed and updates: env-steps/s, the share of
   ``Time/train_wait_time``, the params that collected each rollout (with
   overlap, those after update N-2), each overlapped update replayed alone
   from its recorded inputs and state bit for bit; (c) Dreamer-V2 at
   ``exp=dreamer_v2``'s widths on PixelCatcher: its captured step against
   eager on phase 6's replay (B=16, T=50, horizon 15), ms a replay, the
   idle share and top kernels, no B1 launch; ``exp=dreamer_v2`` through
   ``cli.run`` with ``buffer.type=sequential`` and with ``episode`` and
   ``prioritize_ends``, then ``cli_eval``. Alone on the card: ``python -c 'import chip_smoke as c, numpy as np,
   torch, tempfile; from sheeprl_tpu_torch.ops import fused_gru as fg;
   fg.load_library(); rb, s, a, k = c.filled_replay(np,
   c.train_cfg("pixel_catcher"), 80); c.phase_placement(torch, np, fg,
   tempfile.mkdtemp()); c.phase_overlap(torch, np); c.phase_dv2_step(torch,
   np, fg, rb, s, a, k); c.phase_dv2_cli(torch, np, fg,
   tempfile.mkdtemp())'`` (TF32 off first).
18. Dreamer-V1, then Plan2Explore over Dreamer-V2 and V1, at
   each exp's widths, bf16-mixed: (a) the Dreamer-V1 step (dense 400 x 4,
   ELU, CNN 32, recurrent 200, stochastic 30, horizon 15) and (b) the
   P2E-DV2 and P2E-DV1 exploration steps (10 ensemble members) on phase 6's
   PixelCatcher replay (B x T of ``FAMILY_STEPS``): replays of each CUDA
   graph against eager steps from the same weights within
   ``REPLAY_BOUND``, ms a replay, a profiler window, no B1 or B2 launch;
   (c) ``exp=dreamer_v1``, both explorations and each finetuning from its
   exploration run's checkpoint through ``cli.run``, cut to
   ``FAMILY_CUTS``, with env-steps/s (overall and steady) and the run
   records, then ``cli_eval`` of each. Alone on the card, from a file
   with a ``__main__`` guard (the async envs spawn): ``fg.load_library();
   rb, s, a, k = c.filled_replay(np, c.train_cfg("pixel_catcher"), 80);
   [c.phase_family_step(torch, np, fg, rb, s, a, k, e) for e in
   c.FAMILY_STEPS]; c.phase_family_cli(torch, np, fg, tempfile.mkdtemp())``
   (TF32 off first).
19. The replica fleet (``serve.fleet.enabled``) over phase 12's exp=ppo
   MLP checkpoint at bf16-mixed: two device replica slots on the card (each
   its own stream, graphs and pinned staging), one CPU-spill slot and a
   standby slot (``max_replicas`` 3, ``FLEET_NODE``): (a) every captured
   slot's rungs bit-equal to the same rung run eagerly and equal to the
   plain forward on the slot's device (the card's, the CPU's for the spill
   slot), the standby slot not captured; (b) ``serve ...
   serve.fleet.enabled=true serve.load.enabled=true`` through ``cli.run``, a
   closed loop (``FLEET_LOAD_S``) and a 5-step ramp (``FLEET_RAMP``): QPS,
   p50/p95 against ``slo_ms``, knee and ``max_good_qps``, hedges,
   re-routes, sheds, the hedge scan's lag, the ``variant: fleet`` record;
   (c) the drills: replica 0 killed mid-ramp (nothing dropped or expired,
   p95 within the SLO), ``router_blackhole`` rescued by the scan, autoscale
   up (the standby slot captured first, the pause printed, its rungs held
   as in (a)) and down, ``batch`` traffic on the spill slot, a hot swap
   across every slot under mixed load (every answer equal to the plain
   forward of its stamped version); no B1 or B2 launch. Its numbers ride in
   the kernels line under ``fused_gru``'s ``serve_fleet``, beside phase
   15's single server. Alone on the card (phase 12's runs and phase 15
   first): ``python -c 'import chip_smoke as c, numpy as np, torch,
   tempfile, time; from sheeprl_tpu_torch.ops import fused_gru as fg; d =
   tempfile.mkdtemp(); c.phase_ppo_cli(torch, d); s = c.phase_serve(torch,
   np, fg, d); c.phase_fleet(torch, np, fg, d, s, print)'`` (TF32 off
   first).
20. The flagship's own default configs on the port's classic-control
   frames, the profilers, model registration and ``cli_agents``: (a)
   ``exp=dreamer_v3`` through ``cli.run`` as composed (CartPole-v1 pixels
   drawn by ``envs/render.py``, 64 x 64, S widths, bf16-mixed, 4 async
   envs) cut to ``PIXEL_CUTS`` (depth only; video capture off, as moviepy
   is absent), with ``metric.telemetry.profile_windows=[PROFILE_WINDOW]``,
   a window after the step's capture: B1's launches, the triggered trace
   and its ``gru_step`` kernels, the traced window's train span beside the
   untraced ones; (b) ``cli_registration`` of (a)'s last checkpoint: the
   registry holds ``configs/model_manager/dreamer_v3.yaml``'s five models,
   each artifact equal to the checkpoint's arrays; (c) ``exp=sac_ae`` as
   composed (Pendulum-v1 pixels, frame stack 3) cut to ``SAC_AE_PIXEL_CUTS``,
   no B1; (d) ``metric.profiler.enabled=True`` around a short ``exp=ppo``
   run: a whole-run trace with CUDA kernel events; (e) ``cli_agents`` lists
   the 15 registered algorithms; (f) host ms a rendered and resized frame
   of each env, (a)'s and (c)'s env-steps/s, and whether dm_control and
   mujoco are installed. Alone on the card, from a file with a
   ``__main__`` guard (the async envs spawn): ``fg.load_library();
   c.phase_default_configs(torch, np, fg, tempfile.mkdtemp(), print)``
   (TF32 off first). ``phase_capture_window``, beside it and not run here,
   traces the window that captures the step.
21. Three more classic-control ids, SGD, the poll probe and the DMC check:
   (a) ``exp=dreamer_v3 env.id=MountainCarContinuous-v0`` through
   ``cli.run`` as composed (its frames drawn on the host, S, bf16-mixed)
   cut to ``PIXEL_CUTS`` with the host buffer (``buffer.device=False``), so
   replay gathers through the native kernel (``sheeprl_tpu_torch/native``,
   counted): env-steps/s, B1's launches (every one with a bf16 ``x``), host
   ms a frame drawn and resized, and one batch of a host buffer of the
   env's frames gathered by the kernel bit-equal to numpy's gather of the
   same draws; (b) ``exp=dreamer_v3 env.id=Acrobot-v1`` cut to
   ``ACROBOT_CUTS``, metrics finite; (c) ``exp=ppo`` on MountainCar-v0 and
   on Acrobot-v1 (the latter with ``optim=sgd``): each update captured
   against eager as 12(a) holds it, then 2 updates of each through the
   CLI; (d) a ``device_poll`` event with ``rtt_ms`` from (c)'s MountainCar
   run with ``metric.telemetry.poll_rtt=True``; (e) whether dm_control is
   installed, and where it is absent that building
   ``exp=dreamer_v3_dmc_walker_walk``'s env raises ``ModuleNotFoundError``
   naming it (no DMC run is faked). Alone on the card, from a file with a
   ``__main__`` guard: ``fg.load_library(); c.phase_more_classic(torch, np,
   fg, tempfile.mkdtemp(), print)`` (TF32 off first).
5. The kernels line (JSON), then the device line (JSON) last.

``python3 chip_smoke.py --swap-drills N`` runs, in place of the phases,
phase 12(b)'s PPO run for a checkpoint and then 19(c)'s hot swap N times
back to back (``swap_drill_repeats``): each pause of serving by part, and
a non-zero exit if any run dropped or expired a request.

Each phase prints its seconds and the smoke's so far.

TF32 is off for every phase (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so the plain versions compute in full
fp32 like the kernels, and the fp32 heads of phase 8 in fp32.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from unittest import mock

# forward tolerance of the kernel against its plain version: both are fp32
# with sums taken in another order (the JAX package holds its own kernel to
# the same 1e-5, tests/test_ops/test_pallas_gru.py)
FWD_TOL = 1e-5
# gradients: the backward recomputes through the plain version
GRAD_TOL = 1e-4
# h trajectories of the fused and plain players over the replayed steps:
# per-step fp32 differences of ~1e-6 carried through the recurrence
TRAJ_TOL = 1e-4
# the sharded step with a bf16 W2 against reference_step on the upcast W2:
# the same values in fp32, with XL's 12288-wide LayerNorm summed in another
# order
BF16_STEP_TOL = 1e-4

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
# bf16 passes the tensor-core route makes over each product: the fp32
# activations split into three bf16 planes
TC_PLANES = 3

# the device work of one fused_gru step, by profiler name: the two launches
# of gru_step
FUSED_GRU_KERNELS = ("gru_step",)

PLAYER_STEPS = 32
EVAL_CAP = 64
SEED = 5
# phases 2-7 pin fp32; phase 8 runs the default, bf16-mixed
# (configs/fabric/default.yaml:8, kept by exp=dreamer_v3)
FP32 = "32-true"
BF16 = "bf16-mixed"


def clocks_line() -> str:
    """The card's SM clock, its maximum, power draw and temperature now, as
    ``nvidia-smi`` reads them: beside a timing, they tell a slower card
    state from a slower program."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gru_args(torch, batch: int, in_dim: int, dense: int, hidden: int, gen):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    return [
        r(batch, in_dim),
        r(batch, hidden),
        r(in_dim, dense, scale=in_dim**-0.5),
        r(dense, scale=0.1),
        1 + r(dense, scale=0.1),
        r(dense, scale=0.1),
        r(hidden + dense, 3 * hidden, scale=(hidden + dense) ** -0.5),
        1 + r(3 * hidden, scale=0.1),
        r(3 * hidden, scale=0.1),
    ]


def gru_bound_ms(batch: int, in_dim: int, dense: int, hidden: int, x_bytes: int = 4):
    """Least time of one step on the card: each input read once (x at
    ``x_bytes`` a value: 4 for fp32, 2 for bf16) and the output written once
    over the HBM rate, against the two products' FLOPs over the fp32 rate.
    Returns (ms, 'bytes' or 'operations')."""
    floats = (
        batch * hidden
        + in_dim * dense
        + 3 * dense
        + (hidden + dense) * 3 * hidden
        + 2 * 3 * hidden
        + batch * hidden
    )
    flops = 2 * batch * in_dim * dense + 2 * batch * (hidden + dense) * 3 * hidden
    t_bytes = (4 * floats + x_bytes * batch * in_dim) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def host_ms(torch, fn, iters: int = 200, warmup: int = 20) -> float:
    """CUDA-event time of one ``fn()`` call issued back to back from Python:
    where the launches are short, the host's dispatch sets this pace."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class TraceRange:
    """``FunctionEvent.time_range``'s fields: start and end in us."""

    __slots__ = ("start", "end")

    def __init__(self, start: float, end: float) -> None:
        self.start, self.end = start, end

    def elapsed_us(self) -> float:
        return self.end - self.start


class TraceEvent:
    """The fields of ``FunctionEvent`` that the phases read."""

    __slots__ = ("name", "device_type", "time_range")

    def __init__(self, name: str, device_type, time_range: TraceRange) -> None:
        self.name, self.device_type, self.time_range = name, device_type, time_range


def trace_events(prof) -> list:
    """A finished torch.profiler session's events, as ``prof.events()``
    gives them (its filtered names and hidden events left out, times in us
    from the trace's start), read straight from the session's kineto
    results: ``prof.events()`` builds a ``FunctionEvent`` and the call tree
    for every event, seconds for the trace of a few Dreamer-V3 steps."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    events = []
    for e in res.events():
        name = e.name()
        if name in ("[memory]", "[OutOfMemory]") or getattr(e, "is_hidden_event", lambda: False)():
            continue
        events.append(TraceEvent(name, e.device_type(), TraceRange((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3)))
    return events


def capture(torch, fn, calls: int):
    """``calls`` calls of ``fn()`` captured in one CUDA graph, after three
    warm-up calls on a side stream."""
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
    return graph


def replay_ms(torch, graph, replays: int) -> float:
    """CUDA-event time of one replay of ``graph``, over ``replays`` replays."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def device_ms(torch, fn, calls: int = 20, replays: int = 50) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in one CUDA
    graph, the graph replayed ``replays`` times between CUDA events, so the
    host is out of the loop. The inputs stay in the 50 MB L2 between calls."""
    graph = capture(torch, fn, calls)
    ms = replay_ms(torch, graph, replays) / calls
    del graph
    return ms


def cold_device_ms(torch, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()`` call that finds its inputs out of L2:
    before each captured call a buffer of twice the card's L2 is written; a
    graph of those writes alone is timed and subtracted."""
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    flush = torch.empty(2 * l2 // 4, dtype=torch.float32, device="cuda")

    def cold():
        flush.zero_()
        fn()

    both = capture(torch, cold, calls)
    alone = capture(torch, flush.zero_, calls)
    ms = (replay_ms(torch, both, replays) - replay_ms(torch, alone, replays)) / calls
    del both, alone, flush
    return ms


def launch_breakdown_us(torch, fn, calls: int = 20, replays: int = 10):
    """Device time of each launch of one ``fn()`` call, from torch.profiler
    over replays of a captured graph: [[position: kernel name, us per call],
    ...] in launch order, or None where the profiler saw no device work."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph = capture(torch, fn, calls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    del graph
    events = sorted(
        (e for e in trace_events(prof) if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start
    )
    per_call = len(events) // (replays * calls)
    if not events or per_call * replays * calls != len(events):
        return None
    rows = []
    for i in range(per_call):
        name = re.sub(r"\(.*", "", events[i].name.replace("(anonymous namespace)::", "").replace("void ", ""))
        us = sum(e.time_range.elapsed_us() for e in events[i::per_call]) / (replays * calls)
        rows.append([f"{i}: {name}", us])
    return rows


def phase_kernel(torch, fg, shapes):
    """Kernel against reference_step on the card: forward and gradients at
    every shape, times at every shape. Returns (max_abs_err, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    rows = []
    for name, (batch, in_dim, dense, hidden) in shapes.items():
        args = gru_args(torch, batch, in_dim, dense, hidden, gen)
        with torch.no_grad():
            got = fg.launch(*args)
            want = fg.reference_step(*args)
        torch.cuda.synchronize()
        if got.shape != (batch, hidden) or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel output is not finite [{batch}, {hidden}]")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL):
            raise AssertionError(f"{name}: kernel forward differs from reference_step by {err}")
        worst = max(worst, err)

        leaves = [a.clone().requires_grad_(True) for a in args]
        cot = torch.randn(batch, hidden, device="cuda", generator=gen)
        out = fg.fused_recurrent_step(*leaves)
        g_kernel = torch.autograd.grad(out, leaves, cot)
        ref_leaves = [a.clone().requires_grad_(True) for a in args]
        g_plain = torch.autograd.grad(fg.reference_step(*ref_leaves), ref_leaves, cot)
        gerr = max((a - b).abs().max().item() for a, b in zip(g_kernel, g_plain))
        for a, b in zip(g_kernel, g_plain):
            if not torch.allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL):
                raise AssertionError(f"{name}: gradients differ from reference_step by {gerr}")

        with torch.no_grad():
            ms = device_ms(torch, lambda: fg.launch(*args))
            plain_ms = device_ms(torch, lambda: fg.reference_step(*args))
            cold_ms = cold_device_ms(torch, lambda: fg.launch(*args))
            launches = launch_breakdown_us(torch, lambda: fg.launch(*args))
            call_ms = host_ms(torch, lambda: fg.launch(*args))
            plain_call_ms = host_ms(torch, lambda: fg.reference_step(*args))
        bound_ms, bound_by = gru_bound_ms(batch, in_dim, dense, hidden)
        row = {
            "shape": name,
            "B": batch,
            "X": in_dim,
            "D": dense,
            "H": hidden,
            "max_abs_err": err,
            "grad_max_abs_err": gerr,
            "ms": ms,
            "l2_cold_ms": cold_ms,
            "launches_us": launches,
            "plain_ms": plain_ms,
            "host_call_ms": call_ms,
            "plain_host_call_ms": plain_call_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "plan": fg.step_plan(batch, in_dim, dense, hidden),
        }
        rows.append(row)
        print("fused_gru " + json.dumps(row), flush=True)
        print(
            f"fused_gru {name}: device time (CUDA graph) kernel {1e3 * ms:.1f} us (L2 cold {1e3 * cold_ms:.1f} us),"
            f" plain {1e3 * plain_ms:.1f} us,"
            f" bound {1e3 * bound_ms:.2f} us ({'memory' if bound_by == 'bytes' else 'fp32 arithmetic'} bounds it);"
            f" per call from the host kernel {1e3 * call_ms:.1f} us, plain {1e3 * plain_call_ms:.1f} us;"
            " no library time: no single PyTorch call computes this step",
            flush=True,
        )
    return worst, rows


def proj_bound_ms(batch: int, hidden: int, dense: int, cols: int, w_bytes: int):
    """Least time of one sharded projection: h, feat and W2s (at its storage
    width) read once and out written once over the HBM rate, against its
    operations: for bf16 W2s the three bf16 passes of the fp32-exact product
    over the tensor cores' bf16 rate, for fp32 W2s its FLOPs over the fp32
    rate. Returns (ms, 'bytes' or 'operations', ms of the fp32-rate bound
    that rows of earlier PRs give for either storage)."""
    nbytes = 4 * batch * (hidden + dense + cols) + w_bytes * (hidden + dense) * cols
    flops = 2 * batch * (hidden + dense) * cols
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_fp32 = flops / FP32_FLOP_PER_S
    t_ops = TC_PLANES * flops / BF16_TC_FLOP_PER_S if w_bytes == 2 else t_fp32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), 1e3 * max(t_bytes, t_fp32)


def phase_proj(torch, fg, shapes):
    """sharded_proj's kernel against its plain version at one rank's shapes,
    and its times. Returns (max_abs_err, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    rows = []
    for name, (batch, hidden, dense, cols, w_dtype) in shapes.items():
        h = torch.randn(batch, hidden, device="cuda", generator=gen).tanh()
        feat = torch.nn.functional.silu(torch.randn(batch, dense, device="cuda", generator=gen))
        w2s = (torch.randn(hidden + dense, cols, device="cuda", generator=gen) * (hidden + dense) ** -0.5).to(w_dtype)
        route = fg.proj_plan(h, feat, w2s)[0]
        tc_before = fg.proj_tc_launch_count
        with torch.no_grad():
            got = fg.proj_launch(h, feat, w2s)
            want = fg.proj_reference(h, feat, w2s)
        torch.cuda.synchronize()
        if fg.proj_tc_launch_count - tc_before != (route != "splitk"):
            raise AssertionError(f"sharded_proj {name}: the tensor-core count does not follow route {route}")
        if got.shape != (batch, cols) or not torch.isfinite(got).all():
            raise AssertionError(f"sharded_proj {name}: kernel output is not finite [{batch}, {cols}]")
        err = (got - want).abs().max().item()
        if err > FWD_TOL:
            raise AssertionError(f"sharded_proj {name}: kernel differs from its plain version by {err}")
        worst = max(worst, err)
        # the library call: one cuBLAS product on the concatenated activations
        # and an fp32 copy of W2s, both made outside the timing (for a bf16
        # slice it reads twice the weight bytes the kernel reads)
        hf = torch.cat([h, feat], 1)
        w2f = w2s.float()
        with torch.no_grad():
            ms = device_ms(torch, lambda: fg.proj_launch(h, feat, w2s))
            plain_ms = device_ms(torch, lambda: fg.proj_reference(h, feat, w2s))
            library_ms = device_ms(torch, lambda: torch.mm(hf, w2f))
            call_ms = host_ms(torch, lambda: fg.proj_launch(h, feat, w2s))
        bound_ms, bound_by, fp32_bound_ms = proj_bound_ms(batch, hidden, dense, cols, w2s.element_size())
        row = {
            "shape": name,
            "B": batch,
            "H": hidden,
            "D": dense,
            "C": cols,
            "w2s_dtype": str(w_dtype).replace("torch.", ""),
            "route": route,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "host_call_ms": call_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "fp32_bound_ms": fp32_bound_ms,
        }
        rows.append(row)
        print("sharded_proj " + json.dumps(row), flush=True)
        del h, feat, w2s, hf, w2f, got, want
    return worst, rows


def np_gru_args(np, seed: int, batch: int, in_dim: int, dense: int, hidden: int):
    """The step's nine arrays, seeded (numpy, as the CPU tests make them)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)

    return [
        r(batch, in_dim),
        np.tanh(r(batch, hidden)),
        r(in_dim, dense, scale=in_dim**-0.5),
        r(dense, scale=0.1),
        1 + r(dense, scale=0.1),
        r(dense, scale=0.1),
        r(hidden + dense, 3 * hidden, scale=(hidden + dense) ** -0.5),
        1 + r(3 * hidden, scale=0.1),
        r(3 * hidden, scale=0.1),
    ]


def phase_sharded_step(torch, np, fg):
    """The model-sharded step on a 1-rank NCCL mesh at full width, through
    shard_recurrent and sharded_recurrent_step. Returns the projection
    kernel's launches on this path."""
    import tempfile

    import torch.distributed as dist

    from sheeprl_tpu_torch.algos.dreamer_v3.convert import shard_recurrent
    from sheeprl_tpu_torch.parallel.mesh import init_distributed, make_mesh

    # (B, X, D, H, W2 storage): S = the player's widths; XL = 32*32 + 3 inputs
    cases = {
        "S_B4": (4, 1027, 512, 512, None),
        "S_B16": (16, 1027, 512, 512, None),
        "XL_B16_bf16": (16, 1027, 1024, 4096, torch.bfloat16),
    }
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store:
        init_distributed("cuda", f"file://{store}/store", 1, 0)
        try:
            mesh = make_mesh(1, 1, "cuda")
            full, local = {}, {}
            for i, (name, (batch, in_dim, dense, hidden, w_dtype)) in enumerate(cases.items()):
                arrays = np_gru_args(np, SEED + i, batch, in_dim, dense, hidden)
                full[name] = [torch.from_numpy(a).cuda() for a in arrays]
                local[name] = [t.cuda() for t in shard_recurrent(arrays, 1, 0, w_dtype)]
                del arrays
            grad_leaves = [t.clone().requires_grad_(True) for t in local["S_B4"]]
            torch.cuda.synchronize()

            # ---- the main path: counts at 0 just before, read just after ----
            fg.reset_launch_count()
            with torch.no_grad():
                outs = {name: fg.sharded_recurrent_step(*args, mesh=mesh) for name, args in local.items()}
            fg.sharded_recurrent_step(*grad_leaves, mesh=mesh).square().sum().backward()
            torch.cuda.synchronize()
            launches = fg.proj_launch_count
            tc_launches = fg.proj_tc_launch_count
            # ------------------------------------------------------------------
            if launches != len(cases) + 1:
                raise AssertionError(f"sharded_proj launched {launches} times for {len(cases) + 1} sharded steps")
            bf16_steps = sum(c[4] is not None for c in cases.values())
            if tc_launches != bf16_steps:
                raise AssertionError(f"sharded_proj took the tensor cores {tc_launches} times for {bf16_steps} bf16 steps")

            report = {
                "mesh": list(mesh.shape),
                "backend": dist.get_backend(),
                "launches": launches,
                "tc_launches": tc_launches,
            }
            with torch.no_grad():
                for name, (batch, _, _, hidden, w_dtype) in cases.items():
                    got = outs[name]
                    if got.shape != (batch, hidden) or not torch.isfinite(got).all():
                        raise AssertionError(f"sharded step {name}: output is not finite [{batch}, {hidden}]")
                    ref_args = list(full[name])
                    if w_dtype is not None:  # the reference reads the same, upcast values
                        ref_args[6] = local[name][6].float()
                    want = fg.reference_step(*ref_args)
                    tol = FWD_TOL if w_dtype is None else BF16_STEP_TOL
                    err = (got - want).abs().max().item()
                    if not torch.allclose(got, want, atol=tol, rtol=tol):
                        raise AssertionError(f"sharded step {name}: differs from reference_step by {err}")
                    report[f"{name}_vs_reference"] = err
                    if w_dtype is None:
                        fused = fg.launch(*full[name])
                        ferr = (got - fused).abs().max().item()
                        if not torch.allclose(got, fused, atol=tol, rtol=tol):
                            raise AssertionError(f"sharded step {name}: differs from fused_recurrent_step by {ferr}")
                        report[f"{name}_vs_fused_gru"] = ferr
            ref_leaves = [t.clone().requires_grad_(True) for t in full["S_B4"]]
            fg.reference_step(*ref_leaves).square().sum().backward()
            gerr = max((a.grad - b.grad).abs().max().item() for a, b in zip(grad_leaves, ref_leaves))
            for i, (a, b) in enumerate(zip(grad_leaves, ref_leaves)):
                if not torch.allclose(a.grad, b.grad, atol=GRAD_TOL, rtol=GRAD_TOL):
                    raise AssertionError(f"sharded step S_B4: gradient of input {i} differs from plain autograd")
            report["S_B4_grad_vs_autograd"] = gerr

            # use_pallas=False: the plain projection inside the same step
            before = fg.proj_launch_count
            with torch.no_grad():
                for name in ("S_B4", "S_B16"):
                    plain = fg.sharded_recurrent_step(*local[name], mesh=mesh, use_pallas=False)
                    perr = (outs[name] - plain).abs().max().item()
                    if not torch.allclose(outs[name], plain, atol=FWD_TOL, rtol=FWD_TOL):
                        raise AssertionError(f"sharded step {name}: use_pallas=False differs by {perr}")
                    report[f"{name}_vs_use_pallas_false"] = perr
            if fg.proj_launch_count != before:
                raise AssertionError("sharded_recurrent_step(use_pallas=False) launched the projection kernel")
        finally:
            dist.destroy_process_group()

        # the launcher's CUDA ranks: the S B=4 step on one spawned rank
        from sheeprl_tpu_torch.parallel import launch

        np.savez(f"{store}/in.npz", **{f"a{i}": a for i, a in enumerate(np_gru_args(np, SEED, 4, 1027, 512, 512))})
        t0 = time.perf_counter()
        launch.run(launched_rank, 1, f"{store}/in.npz", f"{store}/out.npz", timeout=300)
        report["launch_run_cuda_seconds"] = time.perf_counter() - t0
        with np.load(f"{store}/out.npz") as f:
            got, child_launches, backend = torch.from_numpy(f["h"]).cuda(), int(f["launches"]), str(f["backend"])
        lerr = (got - outs["S_B4"]).abs().max().item()
        if backend != "nccl" or child_launches != 1 or not torch.allclose(got, outs["S_B4"], atol=FWD_TOL, rtol=FWD_TOL):
            raise AssertionError(
                f"launch.run's CUDA rank: backend {backend}, {child_launches} launches, h' differs by {lerr}"
            )
        report["S_B4_launch_run_vs_in_process"] = lerr
    print("sharded_step " + json.dumps(report), flush=True)
    return launches


def launched_rank(rank: int, world: int, in_path: str, out_path: str) -> None:
    """Rank body for ``parallel.launch.run`` on the card: the sharded step on
    a 1 x ``world`` mesh of the launcher's default device, h' and this
    process's launch count to ``out_path``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sheeprl_tpu_torch.algos.dreamer_v3.convert import shard_recurrent
    from sheeprl_tpu_torch.ops import fused_gru as fg
    from sheeprl_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(1, world)
    with np.load(in_path) as f:
        local = [t.cuda() for t in shard_recurrent([f[f"a{i}"] for i in range(9)], world, rank)]
    fg.reset_launch_count()
    with torch.no_grad():
        h = fg.sharded_recurrent_step(*local, mesh=mesh)
    torch.cuda.synchronize()
    if rank == 0:
        np.savez(out_path, h=h.cpu().numpy(), launches=fg.proj_launch_count, backend=dist.get_backend())


def run_player(torch, np, player, cfg, envs, steps, generator, greedy, sample_state, replay=None):
    """Step the player on the envs (or on ``replay``'s recorded observations
    and resets). Returns (record, h trajectory, actions, seconds)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import env_action, prepare_obs

    cnn_keys = cfg["algo"]["cnn_keys"]["encoder"]
    n = player.num_envs
    record = {"obs": [], "resets": []}
    hs, acts = [], []
    player.init_states()
    if replay is None:
        obs = {k: np.stack([o[k] for o in [e.reset(seed=SEED + i)[0] for i, e in enumerate(envs)]]) for k in cnn_keys}
    t0 = time.perf_counter()
    for t in range(steps):
        if replay is not None:
            obs = replay["obs"][t]
            if replay["resets"][t]:
                player.init_states(replay["resets"][t])
        actions = player.get_actions(prepare_obs(obs, cnn_keys, n), generator, greedy, sample_state)
        hs.append(player.h.clone())
        acts.append(actions)
        if replay is not None:
            continue
        record["obs"].append(obs)
        frames, resets = [], []
        for i, env in enumerate(envs):
            a = env_action(actions[i], player.actions_dim, player.actor.is_continuous)
            o, _, terminated, truncated, _ = env.step(a)
            if terminated or truncated:
                o, _ = env.reset()
                resets.append(i)
            frames.append(o)
        obs = {k: np.stack([f[k] for f in frames]) for k in cnn_keys}
        record["resets"].append(resets)
        if resets:
            player.init_states(resets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # a reset recorded after step t applies before step t + 1
    record["resets"] = [[]] + record["resets"][:-1]
    return record, torch.stack(hs), np.stack(acts), seconds


def profile_player(torch, np, player, cfg, envs, steps, generator):
    """torch.profiler over ``steps`` sampled player steps: device busy time
    per step (kernel durations summed), the idle share of the window, the
    fused_gru kernels' share of device time, and the top kernels. None
    where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, seconds = run_player(torch, np, player, cfg, envs, steps, generator, False, True)
    by_name = {}
    for e in trace_events(prof):
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    ours = sum(v for k, v in by_name.items() if any(n in k for n in FUSED_GRU_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": steps,
        "wall_ms_per_step": 1e3 * seconds / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": (1.0 - busy_us / 1e6 / seconds) if busy_us else None,
        "fused_gru_share_of_device_time": (ours / busy_us) if busy_us else None,
        "top_kernels_us_per_step": [[k, v / steps] for k, v in top],
    }


def phase_slice(torch, np, fg):
    """The S player and evaluate() through the kernel, then the fused/plain
    replay. Returns the kernel's launches on the main path."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import evaluate
    from sheeprl_tpu_torch.configs import compose
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims

    cfg = compose(
        "S", overrides={"seed": SEED, "env.num_envs": 4, "env.max_episode_steps": EVAL_CAP, "fabric.precision": FP32}
    )
    envs = [make_env(cfg, SEED + i)() for i in range(cfg["env"]["num_envs"])]
    obs_space = envs[0].observation_space
    actions_dim, is_continuous = action_dims(envs[0].action_space)
    wm, actor, player = build_agent(actions_dim, is_continuous, cfg, obs_space)
    if not wm.fused:
        raise AssertionError("the S world model did not select the fused recurrent kernel")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # warm-up outside the counted run (allocator, cuDNN plans)
    run_player(torch, np, player, cfg, envs, 2, gen, False, True)

    # ---- the main path: counts at 0 just before, read just after ----
    fg.reset_launch_count()
    _, hs, acts, seconds = run_player(torch, np, player, cfg, envs, PLAYER_STEPS, gen, False, True)
    reward, eval_steps = evaluate(cfg)
    launches = fg.launch_count
    # ------------------------------------------------------------------
    expected = PLAYER_STEPS + eval_steps
    if launches != expected:
        raise AssertionError(f"fused_gru launched {launches} times for {expected} player steps")
    if not torch.isfinite(hs).all() or hs.shape != (PLAYER_STEPS, 4, 512):
        raise AssertionError(f"player h trajectory is not finite [{PLAYER_STEPS}, 4, 512]: {tuple(hs.shape)}")
    if acts.shape != (PLAYER_STEPS, 4, 3) or not np.all(acts.sum(-1) == 1.0):
        raise AssertionError(f"player actions are not one-hot [{PLAYER_STEPS}, 4, 3]")
    timing = {
        "player_steps": PLAYER_STEPS,
        "num_envs": 4,
        "ms_per_player_step": 1e3 * seconds / PLAYER_STEPS,
        "env_steps_per_s": 4 * PLAYER_STEPS / seconds,
        "eval_reward": reward,
        "eval_steps": eval_steps,
    }
    print("slice " + json.dumps(timing), flush=True)
    print("profile " + json.dumps(profile_player(torch, np, player, cfg, envs, 8, gen)), flush=True)

    # ---- fused vs plain on the same observations, mode/greedy ----
    record, h_fused, a_fused, _ = run_player(torch, np, player, cfg, envs, PLAYER_STEPS, None, True, False)
    plain_cfg = compose(
        "S",
        overrides={
            "seed": SEED,
            "env.num_envs": 4,
            "algo.world_model.recurrent_model.fused": "flax",
            "fabric.precision": FP32,
        },
    )
    wm_plain, _, player_plain = build_agent(
        actions_dim, is_continuous, plain_cfg, obs_space, wm.state_dict(), actor.state_dict()
    )
    if wm_plain.fused:
        raise AssertionError("fused='flax' did not select the plain recurrent model")
    before = fg.launch_count
    _, h_plain, a_plain, _ = run_player(
        torch, np, player_plain, plain_cfg, envs, PLAYER_STEPS, None, True, False, replay=record
    )
    if fg.launch_count != before:
        raise AssertionError("the plain player launched the fused kernel")
    traj_err = (h_fused - h_plain).abs().max().item()
    print(f"slice fused-vs-plain h max_abs_err {traj_err:.3e} over {PLAYER_STEPS} steps", flush=True)
    if not torch.allclose(h_fused, h_plain, atol=TRAJ_TOL, rtol=TRAJ_TOL):
        raise AssertionError(f"fused and plain h trajectories differ by {traj_err}")
    if not np.array_equal(a_fused, a_plain):
        raise AssertionError("fused and plain greedy actions differ")
    for env in envs:
        env.close()
    return launches


# phase 6: Dreamer-V3 S training at full width (configs/exp/dreamer_v3.yaml:
# 16 sequences of 64 steps; configs/algo/dreamer_v3.yaml: horizon 15)
TRAIN_B, TRAIN_T, HORIZON = 16, 64, 15
# B1 calls a gradient step: one a scan step at B=16, one an imagination step
# (horizon + 1 of them) at B=16*64=1024; the backward recomputes the plain step
SCAN_CALLS, IMAGINE_CALLS = TRAIN_T, HORIZON + 1
# the fused (B1) and plain (fused: flax) train steps on the same weights and
# batch: each metric within METRIC_BOUND of the plain one relative to
# max(|plain|, 1), each world-model gradient tensor within GRAD_BOUND of the
# plain one relative to its largest element. Both hold B1's 1e-6-level
# differences from the plain step through 64 recurrent steps, their
# backward and 16 imagination steps at B=1024.
METRIC_BOUND = 1e-3
GRAD_BOUND = 1e-3
TIMED_STEPS, WARMUP_STEPS = 3, 2  # 5, 3 until phase 16 needed the time
# the short loop: a few hundred env steps of main(), cut from the exp's
# 5M steps, 1024 learning_starts and 1M-step buffer (384 env steps until
# phase 14 and 320 until phase 16 needed the time)
LOOP_CUTS = {"algo.total_steps": 288, "algo.learning_starts": 256, "buffer.size": 4096}
# eager steps in 6(c)'s profiler window of each step (4 until phase 16)
PROFILED_EAGER_STEPS = 2


# the samplers of phase 6's parity checks; tests/test_torch_cuda.py uses them too
def smooth_state(logits, generator=None, sample=True):
    """The RSSM's latent, deterministic: the categorical's probabilities
    (straight through) for a sample, its one-hot mode otherwise. An argmax
    in their place could flip on a near tie between fp32 logits that differ
    by 1e-6, which over 2^19 categoricals a step is likely and is no fault."""
    from sheeprl_tpu_torch.ops.distributions import OneHotCategorical

    d = OneHotCategorical(logits)
    z = d.probs if sample else d.mode
    return z.reshape(*z.shape[:-2], -1)


def smooth_actions(actor, state, generator=None, greedy=False):
    """The actor's action, deterministic: a normal head's location, the
    discrete heads' probabilities."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import actor_dists

    dists = actor_dists(actor, actor(state))
    if actor.is_continuous:
        return dists[0].mean
    return torch.cat([d.probs for d in dists], -1)


def train_cfg(env: str, fused: str = "auto", precision: str = FP32, **cuts):
    from sheeprl_tpu_torch.configs import compose

    return compose(
        "S",
        env=env,
        overrides={
            "seed": SEED,
            "algo.world_model.recurrent_model.fused": fused,
            "fabric.precision": precision,
            **cuts,
        },
    )


def filled_replay(np, cfg, env_steps: int, capacity=None, ring=None):
    """The port's host sequence replay (``capacity`` steps an env, default
    ``4 * env_steps``) filled by ``env_steps`` random-action steps of
    ``cfg``'s envs; ``ring``, a device ring of the same capacity, gets the
    same adds."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import random_actions
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims

    n = int(cfg["env"]["num_envs"])
    keys = list(cfg["algo"]["cnn_keys"]["encoder"]) + list(cfg["algo"]["mlp_keys"]["encoder"])
    cnn = list(cfg["algo"]["cnn_keys"]["encoder"])
    envs = [make_env(cfg, SEED + i)() for i in range(n)]
    space, obs_space = envs[0].action_space, envs[0].observation_space
    actions_dim, is_continuous = action_dims(space)
    rb = EnvIndependentReplayBuffer(
        capacity or 4 * env_steps, n_envs=n, obs_keys=keys, buffer_cls=SequentialReplayBuffer, seed=SEED
    )
    rng = np.random.default_rng(SEED)
    obs = [e.reset(seed=SEED + i)[0] for i, e in enumerate(envs)]
    first = np.ones((1, n, 1), np.float32)
    for _ in range(env_steps):
        actions, real = random_actions(rng, space, actions_dim, n)
        step = prepare_obs({k: np.stack([o[k] for o in obs]) for k in keys}, cnn, n)
        step = {k: v[None] for k, v in step.items()}
        outs = [e.step(np.asarray(real[i]).reshape(space.shape)) for i, e in enumerate(envs)]
        step.update(
            actions=np.asarray(actions, np.float32)[None],
            rewards=np.array([o[1] for o in outs], np.float32).reshape(1, n, 1),
            terminated=np.array([o[2] for o in outs], np.float32).reshape(1, n, 1),
            truncated=np.array([o[3] for o in outs], np.float32).reshape(1, n, 1),
            is_first=first,
        )
        rb.add(step)
        if ring is not None:
            ring.add(step)
        first = np.array([o[2] or o[3] for o in outs], np.float32).reshape(1, n, 1)
        obs = [e.reset()[0] if o[2] or o[3] else o[0] for e, o in zip(envs, outs)]
    for e in envs:
        e.close()
    return rb, obs_space, actions_dim, is_continuous


def train_models(torch, cfg, obs_space, actions_dim, is_continuous, states=None):
    """World model, actor, critic and target critic, the train step and the
    optimizers of ``cfg`` on the card: seeded, or ``states``' weights."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent, build_critic
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers, make_train_step

    states = states or {}
    wm, actor, _ = build_agent(
        actions_dim, is_continuous, cfg, obs_space, states.get("wm"), states.get("actor"), device="cuda"
    )
    critic, target = build_critic(cfg, wm.latent_state_size, states.get("critic"), states.get("target"), "cuda")
    opts = build_optimizers(cfg, wm, actor, critic)
    step = make_train_step(wm, actor, critic, target, *opts, cfg, is_continuous)
    models = {"wm": wm, "actor": actor, "critic": critic, "target": target}
    return models, step, opts


def snapshot(models):
    return {k: {n: v.detach().clone() for n, v in m.state_dict().items()} for k, m in models.items()}


def one_step(torch, fg, step, batch, grads=None):
    """One gradient step from fresh Moments; returns (metrics, B1 launches)."""
    from sheeprl_tpu_torch.ops.math import init_moments

    fg.reset_launch_count()
    _, metrics = step(init_moments(torch.device("cuda")), batch, None, grads)
    torch.cuda.synchronize()
    return metrics, fg.launch_count


@contextlib.contextmanager
def deterministic():
    """The smooth samplers in place of the port's, where its modules look
    them up, for the length of the block."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import agent, dreamer_v3

    with mock.patch.object(agent, "compute_stochastic_state", smooth_state):
        with mock.patch.object(dreamer_v3, "sample_actor_actions", smooth_actions):
            yield


def phase_train_parity(torch, np, fg):
    """(a) the fused (B1) and plain train steps on one batch drawn from the
    port's replay (PixelCatcher), seeded weights, the smooth sampler; (b) B1
    launches a step, and one continuous-action step (the dummy env) whose
    actor gradient runs B1's backward at B=1024."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, to_batch

    cfg = train_cfg("pixel_catcher")
    rb, obs_space, actions_dim, is_continuous = filled_replay(np, cfg, 80)
    batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda"))
    if tuple(batch["rgb"].shape) != (TRAIN_T, TRAIN_B, 64, 64, 3):
        raise AssertionError(f"replay batch is {tuple(batch['rgb'].shape)}")
    with deterministic():
        fused, fused_step, _ = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
        if not fused["wm"].fused:
            raise AssertionError("the S world model did not select the fused recurrent kernel")
        plain_cfg = train_cfg("pixel_catcher", fused="flax")
        plain, plain_step, _ = train_models(torch, plain_cfg, obs_space, actions_dim, is_continuous, snapshot(fused))
        g_fused, g_plain = {}, {}
        m_fused, launches = one_step(torch, fg, fused_step, batch, g_fused)
        m_plain, plain_launches = one_step(torch, fg, plain_step, batch, g_plain)
        if launches != SCAN_CALLS + IMAGINE_CALLS or plain_launches != 0:
            raise AssertionError(
                f"fused_gru launched {launches} times a fused step (want {SCAN_CALLS} + {IMAGINE_CALLS})"
                f" and {plain_launches} times a plain one (want 0)"
            )
        if not torch.isfinite(m_fused).all():
            raise AssertionError(f"fused train step metrics are not finite: {m_fused.tolist()}")
        metric_err = ((m_fused - m_plain).abs() / m_plain.abs().clamp_min(1.0)).max().item()
        grad_err = max(
            ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for a, b in zip(g_fused["world_model"], g_plain["world_model"])
        )
        report = {
            "B": TRAIN_B,
            "T": TRAIN_T,
            "horizon": HORIZON,
            "fused_gru_launches_per_step": launches,
            "metrics_fused": dict(zip(METRIC_ORDER, m_fused.tolist())),
            "metric_max_rel_err": metric_err,
            "metric_bound": METRIC_BOUND,
            "world_model_grad_max_rel_err": grad_err,
            "grad_bound": GRAD_BOUND,
        }
        print("train_parity " + json.dumps(report), flush=True)
        if metric_err > METRIC_BOUND or grad_err > GRAD_BOUND:
            raise AssertionError(f"fused and plain train steps differ: metrics {metric_err}, gradients {grad_err}")

        # the continuous-action step: the gradient of the policy loss flows
        # through 16 imagination steps of B1 at B=1024 and their backward
        ccfg = train_cfg("dummy_continuous")
        crb, cspace, cdim, ccont = filled_replay(np, ccfg, 70)
        cbatch = to_batch(crb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda"))
        cmodels, cstep, _ = train_models(torch, ccfg, cspace, cdim, ccont)
        cplain, cplain_step, _ = train_models(
            torch, train_cfg("dummy_continuous", "flax"), cspace, cdim, ccont, snapshot(cmodels)
        )
        cg, cg_plain = {}, {}
        cm, claunches = one_step(torch, fg, cstep, cbatch, cg)
        cm_plain, _ = one_step(torch, fg, cplain_step, cbatch, cg_plain)
        actor_err = max(
            ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(cg["actor"], cg_plain["actor"])
        )
        actor_norm = float(cm[METRIC_ORDER.index("Grads/actor")])
        creport = {
            "actions_dim": list(cdim),
            "fused_gru_launches_per_step": claunches,
            "actor_grad_norm": actor_norm,
            "actor_grad_max_rel_err_vs_plain": actor_err,
            "metric_max_rel_err": ((cm - cm_plain).abs() / cm_plain.abs().clamp_min(1.0)).max().item(),
        }
        print("train_continuous " + json.dumps(creport), flush=True)
        if claunches != SCAN_CALLS + IMAGINE_CALLS or not torch.isfinite(cm).all() or not actor_norm > 0:
            raise AssertionError(f"continuous train step: {creport}")
        if actor_err > GRAD_BOUND:
            raise AssertionError(f"continuous actor gradients through B1 differ from the plain step's by {actor_err}")
    del fused, plain, cmodels, cplain
    return launches, rb, obs_space, actions_dim, is_continuous


RANGES = ("scan_step", "imagine_step", "recurrent", "rssm_scan", "grads", "adam_step")


def profile_train(torch, fg, step, rb, steps: int, moments, gen):
    """torch.profiler over ``steps`` gradient steps (the real sampler),
    with a range around each RSSM step (``dynamic`` in the scan,
    ``imagination``) and each recurrent-model call inside it: device busy
    (kernel time), idle share, B1's share, B1's device time per call at
    B=16 (scan) and B=1024 (imagination), and for each range its host time
    per call, its kernels' device time per call and the device span it
    covers; the top kernels."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3
    from sheeprl_tpu_torch.ops.optim import Adam

    wm = step.wm
    rec = wm.recurrent_model

    def ranged(fn, label, by_batch=True):
        def run(*args, **kwargs):
            with record_function(f"{label}_B{args[0].shape[0]}" if by_batch else label):
                return fn(*args, **kwargs)

        return run

    saved = (dreamer_v3.rssm_scan, dreamer_v3._grads, Adam.step)
    rec.forward = ranged(rec.forward, "recurrent")
    wm.dynamic = ranged(wm.dynamic, "scan_step")
    wm.imagination = ranged(wm.imagination, "imagine_step")
    # the whole observation scan, each backward (world model, actor,
    # critic) and each optimizer step
    dreamer_v3.rssm_scan = ranged(dreamer_v3.rssm_scan, "rssm_scan", False)
    dreamer_v3._grads = ranged(dreamer_v3._grads, "grads", False)
    Adam.step = ranged(Adam.step, "adam_step", False)
    batches = [to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda")) for _ in range(steps)]
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches:
                moments, _ = step(moments, b, gen)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        del rec.forward, wm.dynamic, wm.imagination
        dreamer_v3.rssm_scan, dreamer_v3._grads, Adam.step = saved
    events = trace_events(prof)

    def is_range(e):
        return e.name.split("_B")[0] in RANGES

    kernels = sorted(
        (e for e in events if e.device_type == DeviceType.CUDA and not is_range(e)), key=lambda e: e.time_range.start
    )
    starts = [e.time_range.start for e in kernels]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    # B1's launches in issue order: per step 2 x 64 at B=16, then 2 x 16 at B=1024
    b1 = [e for e in kernels if any(n in e.name for n in FUSED_GRU_KERNELS)]
    per_step = 2 * (SCAN_CALLS + IMAGINE_CALLS)
    spans = {16: [], 1024: []}
    if len(b1) == per_step * steps:
        for i in range(0, len(b1), 2):
            a, b = b1[i], b1[i + 1]
            span = max(a.time_range.end, b.time_range.end) - a.time_range.start
            spans[16 if (i % per_step) < 2 * SCAN_CALLS else 1024].append(span)
    ranges = {}
    for label in sorted({e.name for e in events if is_range(e)}):
        host = [e.time_range.elapsed_us() for e in events if e.name == label and e.device_type == DeviceType.CPU]
        gpu = [e for e in events if e.name == label and e.device_type == DeviceType.CUDA]
        inside = 0.0
        for g in gpu:
            lo = bisect.bisect_left(starts, g.time_range.start)
            hi = bisect.bisect_right(starts, g.time_range.end)
            inside += sum(k.time_range.elapsed_us() for k in kernels[lo:hi])
        ranges[label] = {
            "calls": len(host),
            "host_us_per_call": sum(host) / len(host) if host else None,
            "kernel_us_per_call": inside / len(gpu) if gpu else None,
            "device_span_us_per_call": sum(g.time_range.elapsed_us() for g in gpu) / len(gpu) if gpu else None,
        }
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return moments, {
        "steps": steps,
        "wall_ms_per_step_profiled": 1e3 * seconds / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": (1.0 - busy_us / 1e6 / seconds) if busy_us else None,
        "fused_gru_share_of_device_time": (sum(s for v in spans.values() for s in v) / busy_us) if busy_us else None,
        "fused_gru_us_per_call_B16": (sum(spans[16]) / len(spans[16])) if spans[16] else None,
        "fused_gru_us_per_call_B1024": (sum(spans[1024]) / len(spans[1024])) if spans[1024] else None,
        "ranges": ranges,
        "top_kernels_us_per_step": [[k, v / steps] for k, v in top],
    }


def phase_train_timing(torch, np, fg, rb, obs_space, actions_dim, is_continuous):
    """(c) ms per gradient step, fused and plain in turns (fused, plain,
    plain, fused), wall clock over TIMED_STEPS steps after WARMUP_STEPS;
    then a profiler window over each."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch
    from sheeprl_tpu_torch.ops.math import init_moments

    dev = torch.device("cuda")
    runs = {}
    for fused in ("auto", "flax"):
        cfg = train_cfg("pixel_catcher", fused=fused)
        models, step, _ = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
        step.wm = models["wm"]
        runs[fused] = (models, step)
    batches = [to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev) for _ in range(TIMED_STEPS)]
    times = {"auto": [], "flax": []}
    moments = {k: init_moments(dev) for k in runs}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for fused in ("auto", "flax", "flax", "auto"):
        _, step = runs[fused]
        for b in batches[:WARMUP_STEPS]:
            moments[fused], _ = step(moments[fused], b, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            moments[fused], _ = step(moments[fused], b, gen)
        torch.cuda.synchronize()
        times[fused].append(1e3 * (time.perf_counter() - t0) / len(batches))
    report = {
        "ms_per_gradient_step_fused": times["auto"],
        "ms_per_gradient_step_plain": times["flax"],
        "gradient_steps_per_s_fused": 1e3 / min(times["auto"]),
    }
    print("train_timing " + json.dumps(report), flush=True)
    for fused in ("auto", "flax"):
        _, step = runs[fused]
        moments[fused], prof = profile_train(torch, fg, step, rb, PROFILED_EAGER_STEPS, moments[fused], gen)
        print(f"train_profile_{'fused' if fused == 'auto' else 'plain'} " + json.dumps(prof), flush=True)
    del runs
    return report


def phase_train_loop(torch, np, fg, tmp, precision=FP32, label="train_loop"):
    """(d) main(): a few hundred env steps of the S loop on 4 PixelCatcher
    envs at ``precision``, each gradient step one replay of the captured
    step, then the test episode (``algo.run_test``). Its calls of the
    kernel's wrapper: one a player step (the test episode's too), 80 for each
    of the warm-up steps and 80 recorded into the graph; its launches on the
    card: those calls but the recorded ones, plus 80 a replay; at bf16-mixed
    every call reads a bf16 x. Returns (launches, report)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main as train_main
    from sheeprl_tpu_torch.ops.graph import WARMUP_STEPS

    cfg = train_cfg("pixel_catcher", precision=precision, **LOOP_CUTS, log_base_dir=tmp)
    print(f"{label} cuts " + json.dumps({**LOOP_CUTS, "fabric.precision": precision}), flush=True)
    # ---- the main path: counts at 0 just before, read just after ----
    fg.reset_launch_count()
    out = train_main(cfg, device="cuda")
    calls = fg.launch_count
    bf16_calls = fg.bf16_x_launch_count
    # ------------------------------------------------------------------
    per_step = SCAN_CALLS + IMAGINE_CALLS
    num_envs = cfg["env"]["num_envs"]
    updates = cfg["algo"]["total_steps"] // num_envs
    # the player's steps after learning starts, and the test episode's
    acting = updates - cfg["algo"]["learning_starts"] // num_envs + out["test_steps"]
    captured = out["captured_launches_per_step"]
    launches = calls - captured + captured * out["replays"]
    if (
        captured != per_step
        or out["replays"] != out["gradient_steps"]
        or out["gradient_steps"] == 0
        or out["test_steps"] == 0
        or calls != acting + (WARMUP_STEPS + 1) * per_step
        or bf16_calls != (calls if precision == BF16 else 0)
    ):
        raise AssertionError(
            f"main(): {calls} wrapper calls (want {acting} + {WARMUP_STEPS + 1} x {per_step}), {captured} "
            f"captured a step (want {per_step}), {out['replays']} replays for {out['gradient_steps']} steps, "
            f"{bf16_calls} with a bf16 x"
        )
    if not all(np.isfinite(v) for v in out["metrics"].values()):
        raise AssertionError(f"main(): metrics are not finite: {out['metrics']}")
    report = {
        "env_steps": out["env_steps"],
        "gradient_steps": out["gradient_steps"],
        "seconds": out["seconds"],
        "train_seconds_device": out["train_seconds"],
        "env_steps_per_s": out["env_steps"] / out["seconds"],
        "gradient_steps_per_s": out["gradient_steps"] / out["seconds"],
        "precision": precision,
        "fused_gru_wrapper_calls": calls,
        "fused_gru_bf16_x_wrapper_calls": bf16_calls,
        "fused_gru_captured_per_step": captured,
        "replays": out["replays"],
        "fused_gru_launches": launches,
        "test_steps": out["test_steps"],
        "test_cumulative_reward": out["test_cumulative_reward"],
        "last_metrics": out["metrics"],
    }
    print(f"{label} " + json.dumps(report), flush=True)
    return launches, report


# phase 7: the captured step. (a) replayed against eager steps from the same
# weights and batches with cuDNN's deterministic algorithms: each metric
# within REPLAY_BOUND of the eager one relative to max(|eager|, 1), each
# parameter tensor relative to its largest element; the same kernels run in
# both, the graph only takes the host out
REPLAY_BOUND = 1e-6
REPLAYED_STEPS = 3
# (b) two replays from the same state and batch with the generator moved on
# differ by more than NOISE_MIN in some metric (relative), and re-setting
# the generator reproduces the first within REPLAY_BOUND
NOISE_MIN = 1e-4
REPLAY_TIMED = 8
# eager steps timed in 7(c) (REPLAY_TIMED until phase 16 needed the time)
EAGER_TIMED = 3
# replays in 7(c)'s and 8(d)'s profiler windows (4 until phase 16)
PROFILED_REPLAYS = 2
# (d) the drill: S on PixelCatcher (4 envs), 320 env steps, training from
# 256 (64 steps an env: one sequence), a checkpoint every 64 policy steps, a
# forced NaN at update 72 (one rollback to the checkpoint of policy step
# 256); then a resume from auto to 608. The buffer is not checkpointed, so
# the resumed run refills it for learning_starts past its start (update 81
# + 64) and trains from update 145, where the restored Ratio owes the
# policy steps since its last call
DRILL_CUTS = {"algo.total_steps": 320, "algo.learning_starts": 256, "buffer.size": 4096, "checkpoint.every": 64}
DRILL_FAULT_UPDATE = 72
DRILL_ROLLBACK_TO = "ckpt_256_0.ckpt"
DRILL_RESUME_STEPS = 608


@contextlib.contextmanager
def cudnn_deterministic(torch):
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def captured_step(torch, models, step, opts, batch, generator):
    """The train step as ``main`` captures it, over inputs shaped as
    ``batch`` (holding it); returns (CapturedStep, its Moments)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_fn
    from sheeprl_tpu_torch.ops.math import init_moments

    moments = init_moments(torch.device("cuda"))
    inputs = {k: v.clone() for k, v in batch.items()}
    fn = make_train_fn(step, models["wm"], models["actor"], models["critic"], opts, moments, inputs, generator)
    return fn, moments


def rel_err(torch, got, want):
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def replay_against_eager(torch, np, rb, obs_space, actions_dim, is_continuous, precision):
    """REPLAYED_STEPS replays of the captured step (B1 inside) at
    ``precision`` against as many eager steps, discrete (PixelCatcher) and
    continuous (the dummy env), with the smooth samplers and cuDNN's
    deterministic algorithms. Returns the report; raises past REPLAY_BOUND."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch
    from sheeprl_tpu_torch.ops.math import init_moments

    dev = torch.device("cuda")
    ccfg = train_cfg("dummy_continuous", precision=precision)
    crb, cspace, cdim, ccont = filled_replay(np, ccfg, 70)
    cases = {
        "discrete": (train_cfg("pixel_catcher", precision=precision), rb, obs_space, actions_dim, is_continuous),
        "continuous": (ccfg, crb, cspace, cdim, ccont),
    }
    report = {"bound": REPLAY_BOUND, "precision": precision}
    with cudnn_deterministic(torch), deterministic():
        for name, (cfg, crb_, space, dims, cont) in cases.items():
            graphed, gstep, gopts = train_models(torch, cfg, space, dims, cont)
            eager, estep, eopts = train_models(torch, cfg, space, dims, cont, snapshot(graphed))
            batches = [to_batch(crb_.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev) for _ in range(REPLAYED_STEPS)]
            fn, gmoments = captured_step(torch, graphed, gstep, gopts, batches[0], None)
            emoments = init_moments(dev)
            metric_errs = []
            for b in batches:
                for k, v in b.items():
                    fn.inputs[k].copy_(v)
                got = fn()
                _, want = estep(emoments, b, None)
                metric_errs.append(rel_err(torch, got, want))
            torch.cuda.synchronize()
            param_err = max(
                ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                for k in ("wm", "actor", "critic")
                for a, b in zip(graphed[k].parameters(), eager[k].parameters())
            )
            moments_err = max(rel_err(torch, gmoments.low, emoments.low), rel_err(torch, gmoments.high, emoments.high))
            counts = [int(o.count) for o in gopts] + [int(o.count) for o in eopts]
            report[name] = {
                "metric_max_rel_err_per_step": metric_errs,
                "param_max_rel_err": param_err,
                "moments_max_rel_err": moments_err,
                "adam_counts": counts,
                "captured_fused_gru_calls": fn.captured_launches,
                "replays": fn.replays,
            }
            if (
                max(metric_errs + [param_err, moments_err]) > REPLAY_BOUND
                or counts != [REPLAYED_STEPS] * 6
                or fn.captured_launches != SCAN_CALLS + IMAGINE_CALLS
            ):
                raise AssertionError(f"replayed against eager ({name}, {precision}): {report[name]}")
            del graphed, eager, fn
    return report


def phase_replay_parity(torch, np, rb, obs_space, actions_dim, is_continuous):
    """(a) REPLAYED_STEPS replays of the captured step (B1 inside) against
    as many eager steps, discrete (PixelCatcher) and continuous (the dummy
    env), with the smooth samplers; (b) fresh noise on each replay from the
    registered generator, with the real samplers."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch

    dev = torch.device("cuda")
    report = replay_against_eager(torch, np, rb, obs_space, actions_dim, is_continuous, FP32)

    # (b) the real samplers: noise from the registered train generator
    with cudnn_deterministic(torch):
        cfg = train_cfg("pixel_catcher")
        models, step, opts = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev)
        fn, _ = captured_step(torch, models, step, opts, batch, gen)
        saved = [t.detach().clone() for t in fn.state]
        gen_state = gen.get_state()

        def restore():
            with torch.no_grad():
                for t, v in zip(fn.state, saved):
                    t.copy_(v)

        first = fn()
        restore()
        second = fn()
        restore()
        gen.set_state(gen_state)
        again = fn()
        torch.cuda.synchronize()
        noise = {
            "metric_max_rel_diff_next_draw": rel_err(torch, second, first),
            "metric_max_rel_err_same_draw": rel_err(torch, again, first),
            "min_rel_diff": NOISE_MIN,
        }
        report["noise"] = noise
        if noise["metric_max_rel_diff_next_draw"] <= NOISE_MIN or noise["metric_max_rel_err_same_draw"] > REPLAY_BOUND:
            raise AssertionError(f"replayed noise: {noise}")
        del models, fn, saved
    print("replay_parity " + json.dumps(report), flush=True)
    return report


def profile_replays(torch, fn, replays: int = 4, top: int = 8):
    """torch.profiler over ``replays`` replays of the captured step ``fn``,
    after one unrecorded warm-up replay (the profiler's first records of a
    session can be lost, as in ``profile_window``): wall and device-busy ms
    a replay, the device's idle share, B1's gru_step kernels a replay, their
    ms and share of the busy time, and the top kernels (ms a replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = {}

    def ready(prof):
        # the recorded replays' events, read before the profiler clears them
        seen["kernels"] = [e for e in trace_events(prof) if e.device_type == DeviceType.CUDA]

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=ready
    ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(replays):
            fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        prof.step()
    kernels = seen.get("kernels", [])
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    b1 = [e for e in kernels if any(n in e.name for n in FUSED_GRU_KERNELS)]
    b1_us = sum(e.time_range.elapsed_us() for e in b1)
    by_name = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    return {
        "wall_ms_per_replay": 1e3 * seconds / replays,
        "device_busy_ms_per_replay": busy_us / 1e3 / replays,
        "device_idle_share": 1.0 - busy_us / 1e6 / seconds if busy_us else None,
        "kernels_per_replay": len(kernels) / replays,
        "gru_step_kernels_per_replay": len(b1) / replays,
        "gru_step_ms_per_replay": b1_us / 1e3 / replays,
        "gru_step_share_of_device_time": b1_us / busy_us if busy_us else None,
        "top_kernels_ms_per_replay": [
            [k, v / 1e3 / replays] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        ],
    }


def phase_replay_timing(torch, rb, obs_space, actions_dim, is_continuous):
    """(c) ms per gradient step replayed and eager, B1 (fused: auto) and
    the plain recurrent model (fused: flax), CUDA events around REPLAY_TIMED
    steps (EAGER_TIMED eager), in turns fused, plain, plain, fused; then
    torch.profiler over PROFILED_REPLAYS replays of each: device busy time, idle share, B1's gru_step kernels a
    replayed step (2 launches x 80 calls) and their time, the top kernels."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch
    from sheeprl_tpu_torch.ops.math import init_moments

    dev = torch.device("cuda")
    batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev)
    runs = {}
    for fused in ("auto", "flax"):
        models, step, opts = train_models(torch, train_cfg("pixel_catcher", fused=fused), obs_space, actions_dim, is_continuous)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        fn, _ = captured_step(torch, models, step, opts, batch, gen)
        fn()  # capture and one replay
        runs[fused] = (models, step, fn, gen, init_moments(dev))

    def timed(body, calls=REPLAY_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            body()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / calls

    times = {f"{k}_{mode}": [] for k in ("fused", "plain") for mode in ("replayed", "eager")}
    for fused in ("auto", "flax", "flax", "auto"):
        _, step, fn, gen, moments = runs[fused]
        key = "fused" if fused == "auto" else "plain"
        times[f"{key}_replayed"].append(timed(fn))
        times[f"{key}_eager"].append(timed(lambda: step(moments, batch, gen), EAGER_TIMED))
    report = {f"ms_per_gradient_step_{k}": v for k, v in times.items()}
    for fused in ("auto", "flax"):
        report[f"profile_{'fused' if fused == 'auto' else 'plain'}"] = profile_replays(torch, runs[fused][2], PROFILED_REPLAYS)
    print("replay_timing " + json.dumps(report), flush=True)
    if report["profile_fused"]["gru_step_kernels_per_replay"] != 2 * (SCAN_CALLS + IMAGINE_CALLS):
        raise AssertionError(f"a replayed step ran {report['profile_fused']['gru_step_kernels_per_replay']} gru_step kernels")
    if report["profile_plain"]["gru_step_kernels_per_replay"] != 0:
        raise AssertionError("the plain step ran B1")
    del runs
    return report


def phase_drill(torch, np, tmp):
    """(d) main() with a checkpoint every 64 policy steps and a forced NaN
    at update DRILL_FAULT_UPDATE (one rollback), then a second main()
    resuming from the newest committed checkpoint (auto) to
    DRILL_RESUME_STEPS env steps."""
    import warnings

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main as train_main

    fault = {"enabled": True, "faults": [{"kind": "nan", "at_update": DRILL_FAULT_UPDATE}]}
    common = {**DRILL_CUTS, "log_base_dir": tmp, "run_name": "drill"}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first = train_main(train_cfg("pixel_catcher", **common, **{"resilience.fault_injection": fault}), device="cuda")
        resume = {**common, "checkpoint.resume_from": "auto", "algo.total_steps": DRILL_RESUME_STEPS}
        second = train_main(train_cfg("pixel_catcher", **resume), device="cuda")
    rolled = [str(w.message) for w in caught if "rolled back" in str(w.message)]
    report = {
        "cuts": common,
        "fault_at_update": DRILL_FAULT_UPDATE,
        "first": {k: first[k] for k in ("env_steps", "gradient_steps", "rollbacks", "last_checkpoint", "seconds")},
        "rolled_back": rolled,
        "second": {k: second[k] for k in ("start_update", "env_steps", "gradient_steps", "rollbacks", "seconds")},
        "second_metrics": second["metrics"],
    }
    print("drill " + json.dumps(report), flush=True)
    num_envs = 4
    if (
        first["rollbacks"] != 1
        or first["env_steps"] != DRILL_CUTS["algo.total_steps"]
        or len(rolled) != 1
        or DRILL_ROLLBACK_TO not in rolled[0]
        or second["start_update"] != DRILL_CUTS["algo.total_steps"] // num_envs + 1
        or second["env_steps"] != DRILL_RESUME_STEPS
        or second["gradient_steps"] == 0
        or not all(np.isfinite(v) for v in second["metrics"].values())
    ):
        raise AssertionError(f"rollback and resume drill: {report}")
    return report


# phase 8: the default precision, bf16-mixed. (a) B1 reading a bf16 x at
# the S shapes of the player, the scan and imagination, held to
# reference_step on the same bf16 x at FWD_TOL and GRAD_TOL: both compute in
# fp32 from the same rounded x
BF16_KERNEL_SHAPES = {"S_B4": (4, 1027, 512, 512), "S_B16": (16, 1027, 512, 512), "S_B1024": (1024, 1027, 512, 512)}
BF16_ULP = 2.0**-7
# (b) the eager bf16 S step with B1 against the plain recurrent model at
# bf16 (the flax cell rounds h to bf16 at each of the 64 + 16 steps, B1
# keeps it in fp32) and against the fp32 B1 step, from the same weights and
# batch with the smooth samplers: each metric relative to max(|ref|, 1),
# each gradient tensor relative to its largest element. Both comparisons
# take every bf16 rounding of the step, carried through the scan and
# imagination, so the bounds are bf16's, not the kernel's. Measured on an
# H100 (first run): metrics 3.0e-4 against plain and 1.9e-3 against fp32;
# gradients 2.1e-2 and 3.0e-2 (world model), 6.5e-3 and 5.8e-3 (actor),
# 3.9e-3 and 4.3e-3 (critic)
BF16_METRIC_BOUND = 1e-2
BF16_GRAD_BOUND = 0.1


def phase_bf16_kernel(torch, fg, shapes):
    """(a) B1 with a bf16 x: forward and gradients against reference_step on
    the same bf16 x, dx in bf16; device time (CUDA graph, L2 warm) beside the
    step on the fp32 copy of x and the plain version, and the bound with x
    at 2 bytes. Returns (max_abs_err, rows)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    worst = 0.0
    rows = []
    for name, (batch, in_dim, dense, hidden) in shapes.items():
        args = gru_args(torch, batch, in_dim, dense, hidden, gen)
        args[0] = args[0].bfloat16()
        x32 = args[0].float()
        before = fg.bf16_x_launch_count
        with torch.no_grad():
            got = fg.launch(*args)
            want = fg.reference_step(*args)
        torch.cuda.synchronize()
        if fg.bf16_x_launch_count != before + 1:
            raise AssertionError(f"{name}: a bf16 x was not counted as a bf16-x launch")
        if got.shape != (batch, hidden) or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: bf16-x kernel output is not finite [{batch}, {hidden}]")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL):
            raise AssertionError(f"{name}: bf16-x kernel forward differs from reference_step by {err}")
        worst = max(worst, err)
        leaves = [a.clone().requires_grad_(True) for a in args]
        cot = torch.randn(batch, hidden, device="cuda", generator=gen)
        g_kernel = torch.autograd.grad(fg.fused_recurrent_step(*leaves), leaves, cot)
        ref = [a.clone().requires_grad_(True) for a in args]
        g_plain = torch.autograd.grad(fg.reference_step(*ref), ref, cot)
        if g_kernel[0].dtype != torch.bfloat16:
            raise AssertionError(f"{name}: dx is {g_kernel[0].dtype}, not x's bf16")
        gerr = max((a.float() - b.float()).abs().max().item() for a, b in zip(g_kernel, g_plain))
        # dx is an fp32 gradient rounded to bf16: two sums may round a value
        # to neighbouring bf16 numbers, one ulp (2^-7 relative) apart
        rtols = [BF16_ULP] + [GRAD_TOL] * 8
        if not all(torch.allclose(a.float(), b.float(), atol=GRAD_TOL, rtol=r) for a, b, r in zip(g_kernel, g_plain, rtols)):
            raise AssertionError(f"{name}: bf16-x gradients differ from reference_step by {gerr}")
        with torch.no_grad():
            ms = device_ms(torch, lambda: fg.launch(*args))
            fp32_x_ms = device_ms(torch, lambda: fg.launch(x32, *args[1:]))
            plain_ms = device_ms(torch, lambda: fg.reference_step(*args))
        bound_ms, bound_by = gru_bound_ms(batch, in_dim, dense, hidden, x_bytes=2)
        row = {
            "shape": name,
            "B": batch,
            "x_dtype": "bfloat16",
            "max_abs_err": err,
            "grad_max_abs_err": gerr,
            "ms": ms,
            "fp32_x_ms": fp32_x_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "fp32_x_bound_ms": gru_bound_ms(batch, in_dim, dense, hidden)[0],
        }
        rows.append(row)
        print("fused_gru_bf16_x " + json.dumps(row), flush=True)
    return worst, rows


def phase_bf16_train(torch, np, fg, rb, obs_space, actions_dim, is_continuous):
    """(b) one eager S gradient step at bf16-mixed with B1 against the
    plain recurrent model at bf16-mixed and against the fp32 B1 step, the
    same weights and batch, the smooth samplers; B1 called 80 times a step,
    every call with a bf16 x."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, to_batch

    batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda"))
    per_step = SCAN_CALLS + IMAGINE_CALLS
    with deterministic():
        b1, b1_step, _ = train_models(torch, train_cfg("pixel_catcher", precision=BF16), obs_space, actions_dim, is_continuous)
        if not b1["wm"].fused or b1["wm"].dtype != torch.bfloat16:
            raise AssertionError("the bf16-mixed S world model is not the bf16 B1 model")
        states = snapshot(b1)
        runs = {"b1_bf16": (b1_step, per_step, per_step)}
        for key, fused, precision, want in (("plain_bf16", "flax", BF16, (0, 0)), ("b1_fp32", "auto", FP32, (per_step, 0))):
            _, step, _ = train_models(
                torch, train_cfg("pixel_catcher", fused, precision), obs_space, actions_dim, is_continuous, states
            )
            runs[key] = (step, *want)
        out = {}
        for key, (step, calls, bf16_calls) in runs.items():
            grads = {}
            metrics, launches = one_step(torch, fg, step, batch, grads)
            if (launches, fg.bf16_x_launch_count) != (calls, bf16_calls) or not torch.isfinite(metrics).all():
                raise AssertionError(
                    f"bf16 train step {key}: {launches} B1 calls, {fg.bf16_x_launch_count} with a bf16 x "
                    f"(want {calls}, {bf16_calls}); metrics {metrics.tolist()}"
                )
            out[key] = (metrics, grads)
    m_b1, g_b1 = out["b1_bf16"]
    report = {"B": TRAIN_B, "T": TRAIN_T, "horizon": HORIZON, "fused_gru_bf16_x_calls_per_step": per_step}
    report["metrics_b1_bf16"] = dict(zip(METRIC_ORDER, m_b1.tolist()))
    for ref in ("plain_bf16", "b1_fp32"):
        m, g = out[ref]
        report[f"vs_{ref}"] = {
            "metric_max_rel_err": ((m_b1 - m).abs() / m.abs().clamp_min(1.0)).max().item(),
            **{
                f"{k}_grad_max_rel_err": max(
                    ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(g_b1[k], g[k])
                )
                for k in ("world_model", "actor", "critic")
            },
        }
    report["metric_bound"], report["grad_bound"] = BF16_METRIC_BOUND, BF16_GRAD_BOUND
    print("bf16_train " + json.dumps(report), flush=True)
    for ref in ("plain_bf16", "b1_fp32"):
        errs = report[f"vs_{ref}"]
        if errs["metric_max_rel_err"] > BF16_METRIC_BOUND or max(
            v for k, v in errs.items() if k.endswith("grad_max_rel_err")
        ) > BF16_GRAD_BOUND:
            raise AssertionError(f"the bf16 B1 step against {ref}: {errs}")
    return report


def step_ms(torch, fn, steps: int = REPLAY_TIMED) -> float:
    """CUDA-event ms of one call of ``fn`` (a replayed step), over ``steps``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def phase_bf16_timing(torch, rb, obs_space, actions_dim, is_continuous):
    """(d) ms per replayed S step, B1 and plain, at bf16-mixed and fp32, in
    turns within this call; then torch.profiler over PROFILED_REPLAYS replays of each
    bf16 step: idle share, top kernels, B1's share."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch

    batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda"))
    variants = {"b1_bf16": ("auto", BF16), "plain_bf16": ("flax", BF16), "b1_fp32": ("auto", FP32), "plain_fp32": ("flax", FP32)}
    runs = {}
    for key, (fused, precision) in variants.items():
        models, step, opts = train_models(
            torch, train_cfg("pixel_catcher", fused, precision), obs_space, actions_dim, is_continuous
        )
        fn, _ = captured_step(torch, models, step, opts, batch, torch.Generator(device="cuda").manual_seed(SEED))
        fn()  # capture and one replay
        runs[key] = (models, fn)
    times = {key: [] for key in variants}
    for key in ("b1_bf16", "plain_bf16", "b1_fp32", "plain_fp32", "plain_fp32", "b1_fp32", "plain_bf16", "b1_bf16"):
        times[key].append(step_ms(torch, runs[key][1]))
    report = {f"ms_per_replayed_step_{k}": v for k, v in times.items()}
    for key in ("b1_bf16", "plain_bf16"):
        report[f"profile_{key}"] = profile_replays(torch, runs[key][1], PROFILED_REPLAYS, top=10)
    print("bf16_replay_timing " + json.dumps(report), flush=True)
    if report["profile_b1_bf16"]["gru_step_kernels_per_replay"] != 2 * (SCAN_CALLS + IMAGINE_CALLS):
        raise AssertionError(f"a bf16 replayed step ran {report['profile_b1_bf16']['gru_step_kernels_per_replay']} gru_step kernels")
    if report["profile_plain_bf16"]["gru_step_kernels_per_replay"] != 0:
        raise AssertionError("the plain bf16 step ran B1")
    del runs
    return report


def phase_bf16_player(torch, np, fg):
    """(f) the S player at the default precision (bf16-mixed) on 4
    PixelCatcher envs: one B1 call a step, each with a bf16 x; ms a step and
    env-steps/s. Returns (launches, report)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.configs import compose
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims

    cfg = compose("S", overrides={"seed": SEED, "env.num_envs": 4})
    if cfg["fabric"]["precision"] != BF16:
        raise AssertionError(f"the default precision is {cfg['fabric']['precision']}, not {BF16}")
    envs = [make_env(cfg, SEED + i)() for i in range(cfg["env"]["num_envs"])]
    actions_dim, is_continuous = action_dims(envs[0].action_space)
    wm, _, player = build_agent(actions_dim, is_continuous, cfg, envs[0].observation_space)
    if not wm.fused or wm.dtype != torch.bfloat16:
        raise AssertionError("the default S world model is not the bf16 B1 model")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    run_player(torch, np, player, cfg, envs, 2, gen, False, True)  # warm-up
    # ---- the main path: counts at 0 just before, read just after ----
    fg.reset_launch_count()
    _, hs, acts, seconds = run_player(torch, np, player, cfg, envs, PLAYER_STEPS, gen, False, True)
    launches, bf16_launches = fg.launch_count, fg.bf16_x_launch_count
    # ------------------------------------------------------------------
    for env in envs:
        env.close()
    if launches != PLAYER_STEPS or bf16_launches != PLAYER_STEPS:
        raise AssertionError(f"the bf16 player launched B1 {launches} times, {bf16_launches} with a bf16 x, in {PLAYER_STEPS} steps")
    if not torch.isfinite(hs).all() or hs.dtype != torch.float32 or not np.all(acts.sum(-1) == 1.0):
        raise AssertionError("the bf16 player's h is not finite fp32 or its actions are not one-hot")
    report = {
        "precision": BF16,
        "player_steps": PLAYER_STEPS,
        "num_envs": 4,
        "ms_per_player_step": 1e3 * seconds / PLAYER_STEPS,
        "env_steps_per_s": 4 * PLAYER_STEPS / seconds,
        "fused_gru_bf16_x_launches": bf16_launches,
    }
    print("bf16_player " + json.dumps(report), flush=True)
    return launches, report


# phase 9: replay where the JAX package keeps it, at S width and the default
# bf16-mixed. (a) the Atari-100k exps (configs/exp/dreamer_v3_100k_*.yaml:
# buffer.size 100000, 1 env, 64x64x3 pixels) are where buffer.device=auto
# puts the ring on the card; its bytes within RING_BYTES_TOL of the
# estimate; a ring and a host buffer fed the same steps (RING_CAPACITY an
# env: 80 steps wrap it) gather the same windows bit for bit; RING_DRAWS
# in-graph draws start only where the host allows, each env's share within
# 3 sigma of uniform
ATARI_100K = {"buffer.size": 100000, "env.num_envs": 1}
RING_BYTES_TOL = 0.01
RING_CAPACITY = 72
RING_GATHERS = 8
RING_DRAWS = 10000
# (b) a superstep of SUPERSTEP_K steps over pregathered batches against as
# many replays of the per-step graph with the host EMA between them, at
# bf16-mixed with cuDNN's deterministic algorithms and the real samplers:
# bit for bit is expected (the same kernels in the same order, the train
# generator advanced alike); REPLAY_BOUND is the bound otherwise
SUPERSTEP_K = 4
# (c) the four replay paths, each timed over PATH_WINDOWS windows of
# PATH_STEPS gradient steps, in turns, on buffers of the loop's size
# (buffer.size 100000 over 4 envs, PixelCatcher frames repeated)
PATH_STEPS = 2 * SUPERSTEP_K
PATH_WINDOWS = 1  # 2 until phase 16 needed the time
PATHS = ("host_k0", "ring_k0", "ring_k4", "host_k4")
# each path's profiler window: one superstep's worth of gradient steps (8
# until PR 12; the window's trace took about 21 s a path to read)
PROFILE_STEPS = SUPERSTEP_K
# a per-step path's window (PROFILE_STEPS until phase 16 needed the time)
PROFILE_STEPS_K0 = 2
# (d) main(): phase 8(e)'s loop with buffer.size 100000 (auto picks the
# ring) cut to 288 env steps (384 until phase 13, 320 until phase 16), three
# ways, each once; then the drill: the ring checkpointed with the buffer
# (buffer.checkpoint) at 288 env steps, resumed into the memmapped host
# buffer to 320, and from that into the ring with supersteps to 352
RING_LOOP_CUTS = {**LOOP_CUTS, "buffer.size": 100000}
RING_LOOPS = {
    "host_k0": {"buffer.device": False},
    "ring_k0": {},
    "ring_k4": {"algo.fused_gradient_steps": SUPERSTEP_K},
}
RING_DRILL_CUTS = {"algo.total_steps": 288, "algo.learning_starts": 256, "buffer.size": 4096, "buffer.checkpoint": True}
RING_DRILL_RESUMES = (320, 352)


def phase_ring(torch, np):
    """(a) the placement, the ring's bytes, its gather against the host
    buffer's, and the in-graph draw."""
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import prepare_obs
    from sheeprl_tpu_torch.data.device_buffer import (
        DeviceReplayBuffer,
        draw_from_mask,
        estimate_ring_bytes,
        make_sequential_replay,
        resolve_device_buffer,
        sequence_start_mask,
    )
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims

    dev = torch.device("cuda")
    cfg = train_cfg("pixel_catcher", precision=BF16, **ATARI_100K)
    env = make_env(cfg, SEED)()
    obs_space, (actions_dim, _) = env.observation_space, action_dims(env.action_space)
    size = cfg["buffer"]["size"]
    estimate = estimate_ring_bytes(obs_space, actions_dim, size, 1)
    picked = resolve_device_buffer(cfg, dev, obs_space, actions_dim, size, 1)
    ring = make_sequential_replay(cfg, dev, obs_space, actions_dim, size, 1, ["rgb"], None, SEED)
    obs = prepare_obs({"rgb": env.reset(seed=SEED)[0]["rgb"][None]}, cnn_keys=["rgb"], num_envs=1)
    zeros = np.zeros((1, 1, 1), np.float32)
    ring.add(
        {
            "rgb": obs["rgb"][None],
            "actions": np.zeros((1, 1, sum(actions_dim)), np.float32),
            **{k: zeros for k in ("rewards", "terminated", "truncated", "is_first")},
        }
    )
    env.close()
    report = {
        "atari_100k": {
            "buffer_size": size,
            "num_envs": 1,
            "buffer_device": cfg["buffer"]["device"],
            "device_max_bytes": cfg["buffer"]["device_max_bytes"],
            "picked_ring": picked and isinstance(ring, DeviceReplayBuffer),
            "estimate_bytes": estimate,
            "ring_bytes": ring.ring_bytes(),
            "rel_diff": abs(ring.ring_bytes() - estimate) / estimate,
        }
    }
    del ring
    torch.cuda.empty_cache()

    ring = DeviceReplayBuffer(RING_CAPACITY, n_envs=4, obs_keys=["rgb"], device=dev, seed=SEED)
    rb, *_ = filled_replay(np, train_cfg("pixel_catcher", precision=BF16), 80, capacity=RING_CAPACITY, ring=ring)
    mismatched = []
    for _ in range(RING_GATHERS):
        env_idx, starts = ring.draw_indices(TRAIN_B, TRAIN_T)
        for k, v in ring.gather(env_idx, starts, TRAIN_T).items():
            rows = (starts[:, None] + np.arange(TRAIN_T)) % RING_CAPACITY
            want = np.stack([np.asarray(rb.buffer[e].buffer[k])[r, 0] for e, r in zip(env_idx, rows)], axis=1)
            got = v.cpu().numpy()
            if got.dtype != want.dtype or not np.array_equal(got, want):
                mismatched.append(k)
    bufs, pos, full = ring.superstep_inputs(TRAIN_T)
    mask = sequence_start_mask(pos, full, RING_CAPACITY, TRAIN_T).cpu().numpy()
    valid = [ring._valid_starts(e, TRAIN_T) for e in range(4)]
    mask_ok = all(np.array_equal(np.nonzero(mask[e])[0], valid[e]) for e in range(4))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    env_idx, starts = (t.cpu().numpy() for t in draw_from_mask(gen, torch.from_numpy(mask).to(dev), RING_DRAWS))
    straddling = int(sum(s not in set(valid[e].tolist()) for e, s in zip(env_idx, starts)))
    counts = np.bincount(env_idx, minlength=4)
    sigma = (RING_DRAWS * 0.25 * 0.75) ** 0.5
    report["same_steps"] = {
        "capacity": RING_CAPACITY,
        "env_steps": 80,
        "cursors_ring": ring._pos.tolist(),
        "cursors_host": [b._pos for b in rb.buffer],
        "gathers": RING_GATHERS,
        "mismatched_keys": mismatched,
        "mask_equals_host_valid_starts": mask_ok,
        "draws": RING_DRAWS,
        "straddling_draws": straddling,
        "env_counts": counts.tolist(),
        "worst_env_share_sigmas": float(np.abs(counts - RING_DRAWS / 4).max() / sigma),
    }
    print("ring " + json.dumps(report), flush=True)
    if (
        not report["atari_100k"]["picked_ring"]
        or report["atari_100k"]["rel_diff"] > RING_BYTES_TOL
        or mismatched
        or not mask_ok
        or straddling
        or report["same_steps"]["worst_env_share_sigmas"] > 3
        or report["same_steps"]["cursors_ring"] != report["same_steps"]["cursors_host"]
    ):
        raise AssertionError(f"the device ring: {report}")
    return report


def model_state(models, opts, moments):
    """Every tensor a gradient step updates, by name."""
    out = {f"{k}.{n}": v for k, m in models.items() for n, v in m.state_dict().items()}
    for i, o in enumerate(opts):
        out.update({f"opt{i}.mu{j}": t for j, t in enumerate(o.mu)})
        out.update({f"opt{i}.nu{j}": t for j, t in enumerate(o.nu)})
        out[f"opt{i}.count"] = o.count
    out["moments.low"], out["moments.high"] = moments.low, moments.high
    return out


def phase_superstep_parity(torch, np, rb, obs_space, actions_dim, is_continuous):
    """(b) SUPERSTEP_K steps in one superstep graph against as many replays
    of the per-step graph plus the host EMA, from the same weights, batches
    and train generator; then the gru_step kernels of one superstep replay
    in the profiler."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import ema_, make_fused_train_fn, to_batch
    from sheeprl_tpu_torch.ops.math import init_moments
    from sheeprl_tpu_torch.ops.superstep import pregathered

    dev = torch.device("cuda")
    cfg = train_cfg("pixel_catcher", precision=BF16)
    freq = int(cfg["algo"]["critic"]["per_rank_target_network_update_freq"])
    tau = float(cfg["algo"]["critic"]["tau"])
    with cudnn_deterministic(torch):
        single, sstep, sopts = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
        fused, fstep, fopts = train_models(torch, cfg, obs_space, actions_dim, is_continuous, snapshot(single))
        batches = [to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev) for _ in range(SUPERSTEP_K)]
        sgen = torch.Generator(device="cuda").manual_seed(SEED)
        fgen = torch.Generator(device="cuda").manual_seed(SEED)
        fn, smoments = captured_step(torch, single, sstep, sopts, batches[0], sgen)
        want = []
        for i, b in enumerate(batches):
            if i % freq == 0:
                ema_(single["critic"], single["target"], 1.0 if i == 0 else tau)
            for k, v in b.items():
                fn.inputs[k].copy_(v)
            want.append(fn())
        fmoments = init_moments(dev)
        stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        sfn = make_fused_train_fn(
            fstep, fused["wm"], fused["actor"], fused["critic"], fused["target"], fopts, fmoments, cfg,
            pregathered, SUPERSTEP_K, stack, (fgen,),
        )
        sfn.inputs["counter"].fill_(0)
        got, finite = sfn()
        torch.cuda.synchronize()
        want = torch.stack(want)
        s_state, f_state = model_state(single, sopts, smoments), model_state(fused, fopts, fmoments)
        unequal = [k for k in s_state if not torch.equal(s_state[k], f_state[k])]
        state_err = max(
            ((f_state[k].double() - s_state[k].double()).abs().max() / s_state[k].double().abs().max().clamp_min(1e-30)).item()
            for k in s_state
        )
        report = {
            "K": SUPERSTEP_K,
            "precision": BF16,
            "metrics_bitwise": torch.equal(got, want),
            "metric_max_rel_err": rel_err(torch, got, want),
            "state_tensors": len(s_state),
            "state_tensors_unequal": unequal[:8],
            "state_max_rel_err": state_err,
            "train_generators_equal": torch.equal(sgen.get_state(), fgen.get_state()),
            "finite": finite.tolist(),
            "bound": REPLAY_BOUND,
            "captured_fused_gru_calls": sfn.captured_launches,
        }
        del single, fused, fn
        report["profile"] = profile_replays(torch, sfn, replays=2)
    print("superstep_parity " + json.dumps(report), flush=True)
    per_replay = SUPERSTEP_K * 2 * (SCAN_CALLS + IMAGINE_CALLS)
    if (
        report["metric_max_rel_err"] > REPLAY_BOUND
        or state_err > REPLAY_BOUND
        or not report["train_generators_equal"]
        or not all(report["finite"])
        or sfn.captured_launches != SUPERSTEP_K * (SCAN_CALLS + IMAGINE_CALLS)
        or report["profile"]["gru_step_kernels_per_replay"] != per_replay
    ):
        raise AssertionError(f"a superstep against single replays: {report}")
    del sfn
    return report


def loop_sized_buffers(torch, np, rb):
    """A host buffer and a ring of the loop's size (buffer.size 100000 over
    4 envs), full, holding ``rb``'s PixelCatcher steps repeated."""
    from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer

    per_env = RING_LOOP_CUTS["buffer.size"] // 4
    host = EnvIndependentReplayBuffer(per_env, n_envs=4, obs_keys=["rgb"], buffer_cls=SequentialReplayBuffer, seed=SEED)
    for e, sub in enumerate(rb.buffer):
        host.add({k: np.resize(np.asarray(v)[: sub._pos], (per_env, *v.shape[1:])) for k, v in sub.buffer.items()}, [e])
    return host, DeviceReplayBuffer.from_host_buffer(host, device="cuda", seed=SEED)


def profile_window(torch, window):
    """torch.profiler over one ``window()``, after one unrecorded warm-up
    window (the profiler's first records of a session can be lost): wall
    and device-busy ms, the idle share, and the host-to-device bytes its
    copies moved (from the trace's memcpy records; None where the trace
    carries no byte counts)."""
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    seen = {}

    def ready(prof):
        # the recorded window's events, read before the profiler clears them
        seen["busy_us"] = sum(e.time_range.elapsed_us() for e in trace_events(prof) if e.device_type == DeviceType.CUDA)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                seen["copies"] = [e for e in json.load(f).get("traceEvents", []) if "HtoD" in str(e.get("name", ""))]

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=ready
    ) as prof:
        window()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        prof.step()
    # nothing recorded (the handler never ran) reads as not measured
    busy_us, copies = seen.get("busy_us", 0), seen.get("copies", [])
    h2d = None
    if copies and all("bytes" in e.get("args", {}) for e in copies):
        h2d = sum(int(e["args"]["bytes"]) for e in copies)
    return {
        "wall_ms": 1e3 * seconds,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / seconds if busy_us else None,
        "h2d_copies": len(copies),
        "h2d_bytes": h2d,
    }


def replay_path(torch, np, name, cfg, host, ring, obs_space, actions_dim, is_continuous):
    """One of the four replay paths as ``main`` runs it, on seeded S models:
    returns ``(window, keep)``; ``window(n)`` trains n gradient steps (a
    multiple of K for the fused paths), ``keep`` holds what must live."""
    import itertools

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
        batch_inputs,
        ema_,
        make_fused_train_fn,
        make_train_fn,
        stream_seed,
    )
    from sheeprl_tpu_torch.data.device_buffer import draw_sequence_batch
    from sheeprl_tpu_torch.data.prefetch import BatchPrefetcher
    from sheeprl_tpu_torch.ops.math import init_moments
    from sheeprl_tpu_torch.ops.superstep import SAMPLE_KEY_SALT, pregathered

    dev = torch.device("cuda")
    freq = int(cfg["algo"]["critic"]["per_rank_target_network_update_freq"])
    tau = float(cfg["algo"]["critic"]["tau"])
    models, step, opts = train_models(torch, cfg, obs_space, actions_dim, is_continuous)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    moments = init_moments(dev)
    done = [0]
    use_ring = name.startswith("ring")
    k = int(name.rsplit("_k", 1)[1])
    if k == 0:
        inputs = batch_inputs(ring if use_ring else host, TRAIN_T, TRAIN_B, ["rgb"], dev)
        fn = make_train_fn(step, models["wm"], models["actor"], models["critic"], opts, moments, inputs, gen)
        prefetcher = None if use_ring else BatchPrefetcher(host, TRAIN_B, TRAIN_T, inputs, int(cfg["buffer"]["prefetch"]), fn.done)

        def window(n):
            if use_ring:
                batches = ring.sample_batches(TRAIN_B, TRAIN_T, n, out=fn.inputs)
            else:
                batches = prefetcher.sampled_batches(n)
            for _ in batches:
                if done[0] % freq == 0:
                    ema_(models["critic"], models["target"], 1.0 if done[0] == 0 else tau)
                fn()
                done[0] += 1

        return window, (models, fn, prefetcher)
    feed = None
    if use_ring:
        bufs, pos, full = ring.superstep_inputs(TRAIN_T)
        sample_gen = torch.Generator(device="cuda").manual_seed(stream_seed(SEED, SAMPLE_KEY_SALT))
        fn = make_fused_train_fn(
            step, models["wm"], models["actor"], models["critic"], models["target"], opts, moments, cfg,
            lambda ctx, i: draw_sequence_batch(bufs, pos, full, sample_gen, TRAIN_B, TRAIN_T), k, None, (gen, sample_gen),
        )
    else:
        stack = batch_inputs(host, TRAIN_T, TRAIN_B, ["rgb"], dev, stack=k)
        fn = make_fused_train_fn(
            step, models["wm"], models["actor"], models["critic"], models["target"], opts, moments, cfg,
            pregathered, k, stack, (gen,),
        )
        feed = BatchPrefetcher(host, TRAIN_B, TRAIN_T, stack, int(cfg["buffer"]["prefetch"]), fn.done, n_samples=k)

    def window(n):
        for _ in itertools.repeat(None, n // k) if use_ring else feed.sampled_batches(n // k):
            if use_ring:
                ring.superstep_inputs(TRAIN_T)
            fn.inputs["counter"].fill_(done[0])
            fn()
            done[0] += k

    return window, (models, fn, feed)


def phase_replay_paths(torch, np, rb, obs_space, actions_dim, is_continuous):
    """(c) ms per gradient step, the device's idle share, host-to-device
    bytes per gradient step and peak memory of the four replay paths: the
    host buffer (pinned prefetch) and the ring (a gather on the card), each
    per step (K = 0, the EMA between replays) and in supersteps of K = 4
    (the ring drawing in the graph, the host buffer's batches copied as a
    stack); the K = 1 ring superstep's peak memory beside K = 4's."""
    start = time.perf_counter()
    cfg = train_cfg("pixel_catcher", precision=BF16)
    host, ring = loop_sized_buffers(torch, np, rb)
    report = {"buffer_size": RING_LOOP_CUTS["buffer.size"], "num_envs": 4, "ring_bytes": ring.ring_bytes(), "paths": {}}
    args = (cfg, host, ring, obs_space, actions_dim, is_continuous)
    runs = {}
    for name in ("ring_k1",) + PATHS:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        window, keep = replay_path(torch, np, name, *args)
        window(PATH_STEPS)  # the capture, then a window
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        report["paths"][name] = {"peak_allocated_bytes": peak, "peak_added_bytes": peak - base}
        if name == "ring_k1":
            del window, keep
            torch.cuda.empty_cache()
        else:
            runs[name] = (window, keep)
    report["build_seconds"] = time.perf_counter() - start
    times = {name: [] for name in PATHS}
    report["clocks"] = []
    for name in PATHS + PATHS[::-1]:
        window = runs[name][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PATH_WINDOWS):
            window(PATH_STEPS)
        torch.cuda.synchronize()
        times[name].append(1e3 * (time.perf_counter() - t0) / (PATH_WINDOWS * PATH_STEPS))
        report["clocks"].append(f"{name}: {clocks_line()}")
    report["timed_seconds"] = time.perf_counter() - start
    for name in PATHS:
        steps = PROFILE_STEPS if name.endswith(f"_k{SUPERSTEP_K}") else PROFILE_STEPS_K0
        prof = profile_window(torch, lambda: runs[name][0](steps))
        report["paths"][name].update(
            ms_per_gradient_step=times[name],
            device_idle_share=prof["device_idle_share"],
            device_busy_ms_per_gradient_step=prof["device_busy_ms"] / steps,
            h2d_bytes_per_gradient_step=None if prof["h2d_bytes"] is None else prof["h2d_bytes"] / steps,
            h2d_copies_per_gradient_step=prof["h2d_copies"] / steps,
        )
    report["seconds"] = time.perf_counter() - start
    print("replay_paths " + json.dumps(report), flush=True)
    del runs, host, ring
    torch.cuda.empty_cache()
    return report


def phase_ring_loops(torch, np, fg, tmp):
    """(d) main() at phase 8(e)'s cuts with buffer.size 100000 and 288 env
    steps: the host
    buffer (memmapped) per step, the ring per step, the ring in supersteps
    of K = 4, each once (twice in turns until phase 11 needed the time).
    Returns ({way: the kernel's launches in its run, counted from 0 just
    before it}, report)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main as train_main

    launches, report = {}, {"cuts": RING_LOOP_CUTS, **{name: [] for name in RING_LOOPS}}
    want_buffer = {"host_k0": "memmap", "ring_k0": "device", "ring_k4": "device"}
    for turn, name in enumerate(RING_LOOPS):
        extra = RING_LOOPS[name]
        cfg = train_cfg("pixel_catcher", precision=BF16, **RING_LOOP_CUTS, **extra, log_base_dir=tmp, run_name=f"{name}_{turn}")
        # ---- the main path: counts at 0 just before, read just after ----
        fg.reset_launch_count()
        out = train_main(cfg, device="cuda")
        calls, bf16_calls = fg.launch_count, fg.bf16_x_launch_count
        # ------------------------------------------------------------------
        captured = sum(g["captured_launches"] for g in out["graphs"])
        count = calls - captured + sum(g["captured_launches"] * g["replays"] for g in out["graphs"])
        launches[name] = launches.get(name, 0) + count
        run = {
            "replay_buffer": out["replay_buffer"],
            "env_steps": out["env_steps"],
            "gradient_steps": out["gradient_steps"],
            "seconds": out["seconds"],
            "env_steps_per_s": out["env_steps"] / out["seconds"],
            "gradient_steps_per_s": out["gradient_steps"] / out["seconds"],
            "train_seconds_device": out["train_seconds"],
            # the windows after the first two (which capture the graphs),
            # G = 4 steps each
            "steady_ms_per_gradient_step": 1e3 * float(np.median(out["train_window_seconds"][2:])) / 4,
            "graphs": out["graphs"],
            "fused_gru_launches": count,
            "clocks_after": clocks_line(),
        }
        report[name].append(run)
        if (
            out["replay_buffer"] != want_buffer[name]
            or out["captured_launches_per_step"] != SCAN_CALLS + IMAGINE_CALLS
            or sum(g["steps"] * g["replays"] for g in out["graphs"]) != out["gradient_steps"]
            or out["gradient_steps"] == 0
            or bf16_calls != calls
            or not all(np.isfinite(v) for v in out["metrics"].values())
        ):
            raise AssertionError(f"main() {name}: {run}, {bf16_calls} of {calls} wrapper calls with a bf16 x")
    print("ring_loops " + json.dumps(report), flush=True)
    return launches, report


def phase_ring_drill(torch, np, tmp):
    """(d) the drill: main() on the ring with the buffer checkpointed, the
    checkpoint's ring restored into a memmapped host buffer and back into a
    ring (each equal to the saved contents and cursors), then main()
    resumed from it on the memmapped host buffer, and from that run's
    checkpoint on the ring with supersteps; the counters continue."""
    import os

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main as train_main
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer, adapt_restored_buffer
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    common = {**RING_DRILL_CUTS, "log_base_dir": tmp, "run_name": "ring_drill"}
    first = train_main(train_cfg("pixel_catcher", precision=BF16, **common, **{"buffer.device": True}), device="cuda")
    steps = RING_DRILL_CUTS["algo.total_steps"]
    ckpt = os.path.join(first["log_dir"], "checkpoint", f"ckpt_{steps}_0.ckpt")
    saved = load_checkpoint(ckpt)["rb"]
    want = saved.host_arrays()
    host = adapt_restored_buffer(load_checkpoint(ckpt)["rb"], False, memmap=True, memmap_dir=os.path.join(tmp, "drill_memmap"))
    host_equal = all(host.is_memmap) and all(
        sub._pos == saved._pos[e]
        and sub.full == saved._full[e]
        and all(np.array_equal(np.asarray(sub.buffer[k])[:, 0], want[k][e]) for k in want)
        for e, sub in enumerate(host.buffer)
    )
    ring = adapt_restored_buffer(host, True, seed=SEED, device="cuda")
    back = ring.host_arrays()
    ring_equal = (
        isinstance(ring, DeviceReplayBuffer)
        and np.array_equal(ring._pos, saved._pos)
        and np.array_equal(ring._full, saved._full)
        and all(np.array_equal(back[k], want[k]) for k in want)
    )
    del host, ring
    resume_host = {**common, "buffer.device": False, "checkpoint.resume_from": ckpt, "algo.total_steps": RING_DRILL_RESUMES[0]}
    second = train_main(train_cfg("pixel_catcher", precision=BF16, **resume_host), device="cuda")
    ckpt2 = os.path.join(second["log_dir"], "checkpoint", f"ckpt_{RING_DRILL_RESUMES[0]}_0.ckpt")
    resume_ring = {
        **common,
        "buffer.device": True,
        "algo.fused_gradient_steps": SUPERSTEP_K,
        "checkpoint.resume_from": ckpt2,
        "algo.total_steps": RING_DRILL_RESUMES[1],
    }
    third = train_main(train_cfg("pixel_catcher", precision=BF16, **resume_ring), device="cuda")
    keys = ("replay_buffer", "start_update", "env_steps", "gradient_steps", "seconds")
    report = {
        "cuts": common,
        "restored_host_equals_saved_ring": host_equal,
        "restored_ring_equals_saved_ring": ring_equal,
        "first": {k: first[k] for k in keys},
        "second": {k: second[k] for k in keys},
        "third": {k: third[k] for k in keys},
    }
    print("ring_drill " + json.dumps(report), flush=True)
    num_envs = 4
    resumes = (steps,) + RING_DRILL_RESUMES
    for run, kind, (before, after) in zip((second, third), ("memmap", "device"), zip(resumes, resumes[1:])):
        # the buffer came back, so training resumes at once: Ratio owes one
        # step a policy step since its last call
        if (
            run["replay_buffer"] != kind
            or run["start_update"] != before // num_envs + 1
            or run["env_steps"] != after
            or run["gradient_steps"] != after - before
        ):
            raise AssertionError(f"the ring drill's resume: {report}")
    if first["replay_buffer"] != "device" or not host_equal or not ring_equal:
        raise AssertionError(f"the ring drill: {report}")
    return report


# phase 10: the entry point on the card. The CLI runs 8(e)'s loop (S width,
# bf16-mixed, the ring) with telemetry, a log window every 64 env steps
# (three of them after learning starts) and a checkpoint every 128 with the
# ring in it, so the resume from the mid-run one trains on to the end
CLI_CUTS = {**LOOP_CUTS, "metric.log_every": 64, "checkpoint.every": 128, "buffer.checkpoint": True}
CLI_RESUME_FROM = "ckpt_256_0.ckpt"
CLI_TIMEOUT = 300


def cli_argv(tmp: str, run_name: str, telemetry: bool = True, **extra) -> list:
    """The CLI's arguments: exp=dreamer_v3 on PixelCatcher with the cuts,
    logs and the run registry under ``tmp``."""
    args = {
        "seed": SEED,
        **CLI_CUTS,
        "metric.telemetry.enabled": telemetry,
        "log_base_dir": f"{tmp}/logs",
        "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl",
        "run_name": run_name,
        **extra,
    }
    return ["exp=dreamer_v3", "env=pixel_catcher"] + [f"{k}={v}" for k, v in args.items()]


def run_module(module: str, argv: list, tmp: str) -> tuple:
    """``python -m module argv`` in a temporary cwd with the repository on
    ``PYTHONPATH`` and the run registry under ``tmp``; raises on a non-zero
    exit. Returns (stdout, seconds)."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo, SHEEPRL_TPU_RUNS_JSONL=f"{tmp}/RUNS.jsonl")
    cwd = tempfile.mkdtemp(dir=tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", module, *argv], cwd=cwd, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m {module} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return proc.stdout, seconds


def cli_in_process(torch, fg, argv: list, module=None) -> tuple:
    """``cli.run(argv)`` in this process, its printing kept apart, with
    ``module``'s ``main`` (Dreamer-V3's by default) kept for its report;
    returns (main's report, wrapper calls, calls with a bf16 x, seconds)."""
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3

    module = module or dv3
    out = {}
    real_main = module.main

    def keep(fabric, cfg, **kw):
        out.update(real_main(fabric, cfg, **kw))

    buf = io.StringIO()
    # ---- the main path: counts at 0 just before, read just after ----
    fg.reset_launch_count()
    t0 = time.perf_counter()
    with mock.patch.object(module, "main", keep), contextlib.redirect_stdout(buf):
        cli.run(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    calls, bf16_calls = fg.launch_count, fg.bf16_x_launch_count
    # ------------------------------------------------------------------
    return out, calls, bf16_calls, seconds


def run_dir(tmp: str, run_name: str) -> str:
    return f"{tmp}/logs/dreamer_v3/pixel_catcher/{run_name}"


def phase_cli(torch, np, fg, tmp: str, loop_report: dict):
    """(a) ``python -m sheeprl_tpu_torch exp=dreamer_v3 env=pixel_catcher``
    with telemetry: exit 0, ``config.yaml``, an event file the port's reader
    decodes with every train metric and ``Time/sps_*`` at each log window
    after learning starts (rewards where episodes ended), all finite,
    heartbeats naming the card with a device memory peak and 0 < MFU <= 1,
    one ``completed`` run record; then the same argv in this process through
    ``cli.run`` for the kernel's launches. (b) ``cli_eval`` on (a)'s last
    checkpoint: one capped episode on the card and an eval record. (c) the
    CLI resuming (a)'s mid-run checkpoint with ``fabric.precision=32-true``
    on the command line: the stored config with that override, trained to
    the end. (d) env-steps/s of the in-process CLI run against 8(e)'s loop,
    telemetry on and off, FLOPs a gradient step and the heartbeat's MFU.
    Returns (launches, report)."""
    import glob
    import os

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER
    from sheeprl_tpu_torch.config import load_config_file
    from sheeprl_tpu_torch.obs.registry import read_run_records
    from sheeprl_tpu_torch.ops.graph import WARMUP_STEPS
    from sheeprl_tpu_torch.utils.logger import read_scalars

    t10 = time.perf_counter()
    card = card_line()
    runs = f"{tmp}/RUNS.jsonl"
    # (a) the CLI in a subprocess
    _, a_seconds = run_module("sheeprl_tpu_torch", cli_argv(tmp, "cli_a"), tmp)
    base = run_dir(tmp, "cli_a")
    version = f"{base}/version_0"
    stored = load_config_file(f"{version}/config.yaml")
    if stored["fabric"]["precision"] != BF16 or any(stored.get_nested(k) != v for k, v in CLI_CUTS.items()):
        raise AssertionError(f"cli (a): the stored config is not the run's: {stored['fabric']} {stored['algo']}")
    events = glob.glob(f"{version}/events.out.tfevents.*")
    if len(events) != 1:
        raise AssertionError(f"cli (a): want one event file, found {events}")
    by_step = {}
    for step, tag, value in read_scalars(events[0]):
        by_step.setdefault(step, {})[tag] = value
    # the test episode after training logs its reward alone at step 0
    test_tags = by_step.pop(0, {})
    if set(test_tags) != {"Test/cumulative_reward"} or not np.isfinite(test_tags["Test/cumulative_reward"]):
        raise AssertionError(f"cli (a): the test episode's reward at step 0: {test_tags}")
    learning_starts = CLI_CUTS["algo.learning_starts"]
    train_windows = [s for s in sorted(by_step) if s >= learning_starts]
    want = set(METRIC_ORDER) | {"Time/sps_train", "Time/sps_env_interaction"}
    for step in sorted(by_step):
        tags = by_step[step]
        missing = (want if step in train_windows else {"Time/sps_env_interaction"}) - set(tags)
        if missing or not all(np.isfinite(v) for v in tags.values()):
            raise AssertionError(f"cli (a): event file at step {step}: missing {sorted(missing)} or non-finite {tags}")
    rewards = [s for s in by_step if "Rewards/rew_avg" in by_step[s] and "Game/ep_len_avg" in by_step[s]]
    if len(train_windows) < 2 or not rewards:
        raise AssertionError(f"cli (a): log windows {sorted(by_step)}, reward windows {rewards}")
    beats = [json.loads(line) for line in open(f"{base}/telemetry.jsonl")]
    beats = [e for e in beats if e["event"] == "heartbeat"]
    kind = torch.cuda.get_device_name(0)
    mfus = [b["mfu"] for b in beats if "mfu" in b]
    if (
        len(beats) != len(by_step)
        or any(b["device_kind"] != kind or not b["hbm_peak_bytes"] > 0 for b in beats)
        or not mfus
        or not all(0 < m <= 1 for m in mfus)
    ):
        raise AssertionError(f"cli (a): heartbeats {beats}")
    records = read_run_records(runs)
    if [(r["kind"], r["outcome"], r["run_name"]) for r in records] != [("train", "completed", "cli_a")]:
        raise AssertionError(f"cli (a): run records {records}")
    last_ckpt = f"ckpt_{CLI_CUTS['algo.total_steps']}_0.ckpt"
    ckpts = sorted(os.listdir(f"{version}/checkpoint"))
    if CLI_RESUME_FROM not in ckpts or last_ckpt not in ckpts:
        raise AssertionError(f"cli (a): checkpoints {ckpts}")
    print(
        "cli_train " + json.dumps({
            "seconds_with_startup": a_seconds, "log_steps": sorted(by_step), "train_log_steps": train_windows,
            "heartbeats": len(beats), "mfu": mfus, "flops_per_train_step": beats[-1].get("flops_per_train_step"),
            "hbm_peak_bytes": beats[-1]["hbm_peak_bytes"], "device_kind": kind, "record": records[0]["outcome"],
            "checkpoints": ckpts, "last_metrics": {k: by_step[max(by_step)][k] for k in METRIC_ORDER},
            "test_cumulative_reward": test_tags["Test/cumulative_reward"],
        }),
        flush=True,
    )
    # the same argv in this process: the kernel's launches on the main path
    out, calls, bf16_calls, on_seconds = cli_in_process(torch, fg, cli_argv(tmp, "cli_b"))
    per_step = SCAN_CALLS + IMAGINE_CALLS
    acting = (CLI_CUTS["algo.total_steps"] - learning_starts) // 4 + out["test_steps"]
    captured = out["captured_launches_per_step"]
    launches = calls - captured + captured * out["replays"]
    if (
        captured != per_step
        or out["replays"] != out["gradient_steps"]
        or calls != acting + (WARMUP_STEPS + 1) * per_step
        or bf16_calls != calls
    ):
        raise AssertionError(
            f"cli in process: {calls} wrapper calls (want {acting} + {WARMUP_STEPS + 1} x {per_step}), "
            f"{bf16_calls} with a bf16 x, {captured} captured a step, {out['replays']} replays for {out['gradient_steps']} steps"
        )
    record_b = read_run_records(runs)[-1]
    # (b) cli_eval on (a)'s last checkpoint, one episode capped at EVAL_CAP
    eval_out, b_seconds = run_module(
        "sheeprl_tpu_torch.cli_eval",
        [f"checkpoint_path={version}/checkpoint/{last_ckpt}", f"env.max_episode_steps={EVAL_CAP}"],
        tmp,
    )
    record = read_run_records(runs)[-1]
    if "Test - Reward:" not in eval_out or (record["kind"], record["outcome"]) != ("eval", "completed"):
        raise AssertionError(f"cli_eval: {eval_out[-2000:]} {record}")
    reward = float(eval_out.split("Test - Reward:")[-1].split()[0])
    # (c) resume (a)'s mid-run checkpoint at fp32 from the command line, in
    # this process (a subprocess until phase 16 needed the time)
    _, _, _, c_seconds = cli_in_process(
        torch,
        fg,
        [
            "exp=dreamer_v3",
            "env=pixel_catcher",
            f"checkpoint.resume_from={version}/checkpoint/{CLI_RESUME_FROM}",
            f"fabric.precision={FP32}",
            "metric.telemetry.enabled=True",
            f"metric.telemetry.runs_jsonl={runs}",
            "run_name=cli_c",
        ],
    )
    resumed = load_config_file(f"{run_dir(tmp, 'cli_c')}/version_0/config.yaml")
    record_c = read_run_records(runs)[-1]
    resumed_ckpts = sorted(os.listdir(f"{run_dir(tmp, 'cli_c')}/version_0/checkpoint"))
    if (
        resumed["fabric"]["precision"] != FP32
        or resumed["algo"]["total_steps"] != CLI_CUTS["algo.total_steps"]
        or (record_c["kind"], record_c["outcome"]) != ("train", "completed")
        or not record_c["train_gradient_steps"] > 0
        or last_ckpt not in resumed_ckpts
    ):
        raise AssertionError(f"cli resume: {resumed['fabric']} {record_c} {resumed_ckpts}")
    # (d) the same in-process run with telemetry off
    off, _, _, off_seconds = cli_in_process(torch, fg, cli_argv(tmp, "cli_d", telemetry=False))
    report = {
        "card": card,
        "cuts": CLI_CUTS,
        "env_steps_per_s": {
            "cli_telemetry_on": out["env_steps"] / out["seconds"],
            "cli_telemetry_off": off["env_steps"] / off["seconds"],
            "phase_8e_loop": loop_report["env_steps_per_s"],
        },
        "loop_seconds": {"cli_telemetry_on": out["seconds"], "cli_telemetry_off": off["seconds"], "phase_8e_loop": loop_report["seconds"]},
        "cli_run_seconds_in_process": {"telemetry_on": on_seconds, "telemetry_off": off_seconds, "resume": c_seconds},
        "subprocess_seconds": {"train": a_seconds, "eval": b_seconds},
        "flops_per_gradient_step": record_b.get("flops_per_train_step"),
        "mfu_last_heartbeat": record_b.get("mfu"),
        "mfu_subprocess_heartbeats": mfus,
        "sps_train_registry": record_b.get("sps_train"),
        "fused_gru_wrapper_calls": calls,
        "fused_gru_bf16_x_wrapper_calls": bf16_calls,
        "fused_gru_launches": launches,
        "replays": out["replays"],
        "eval_reward": reward,
        "resume_gradient_steps": record_c["train_gradient_steps"],
        "resume_precision": resumed["fabric"]["precision"],
    }
    print(f"phase 10 on {card}: cli " + json.dumps(report), flush=True)
    print(f"phase 10 took {time.perf_counter() - t10:.1f} s", flush=True)
    return launches, report


# phase 11: the env pipeline on the card. (a) the pixel specs on the card
# against the same specs on the CPU, teacher-forced (both step the CPU
# state) for SPEC_STEPS steps over SPEC_ENVS envs: states within SPEC_TOL
# (absolute, and relative above 1), rewards and flags alike, frames equal
# but for pixels within EDGE_TOL of a mask edge (CUDA contracts the float32
# sums to FMAs, the CPU does not), at most EDGE_SHARE of them; then
# ImageTransform at 128 -> 64 with grayscale against a plain numpy
# reference, bit for bit. (b) Dreamer-V3 S on PixelPendulum through the
# CLI, action repeat 2 on the async backend, at 8(e)'s cuts. (c)
# PixelPointmass rendered at 128, resized to 64 and grayed, an env that
# raises once (RestartOnException, its pause patched to 0), on the ring
SPEC_ENVS = 256
SPEC_STEPS = 50
SPEC_TOL = 1e-6
EDGE_TOL = 1e-5
EDGE_SHARE = 1e-3
PENDULUM_ARGS = {"env.action_repeat": 2, "env.backend": "async", **LOOP_CUTS}
# learning starts once each env holds a 64-step sequence: 256 over 4 envs
RESTART_CUTS = {"algo.total_steps": 288, "algo.learning_starts": 256, "buffer.size": 4096, "buffer.device": True}
RESTART_AT_STEP = 20
VECTOR_STEPS = 200
BACKEND_ORDER = ("async", "sync")


class FlakyPixelEnv:
    """A PixelPointmass env of the port whose ``RESTART_AT_STEP``-th step
    raises, once per process (the env ``_target_`` of phase 11(c))."""

    crashes = 0

    def __new__(cls, **kwargs):
        from sheeprl_tpu_torch.envs.jittable_pixels import JittablePixelEnv

        class Flaky(JittablePixelEnv):
            steps = 0

            def step(self, action):
                self.steps += 1
                if self.steps == RESTART_AT_STEP and FlakyPixelEnv.crashes == 0:
                    FlakyPixelEnv.crashes += 1
                    raise RuntimeError("injected env crash")
                return super().step(action)

        return Flaky(**kwargs)


def edge_gap(np, env_id: str, y, size: int):
    """float64 ``|d^2 - r^2|`` of every pixel to its nearest mask edge in the
    frame of state ``y`` (the masks of ``envs/jittable_pixels.py``)."""
    px = (np.arange(size) + 0.5) / size
    xx, yy = np.meshgrid(px, px, indexing="xy")
    if env_id.startswith("PixelPointmass"):
        gaps = [np.abs((xx - cx) ** 2 + (yy - cy) ** 2 - r**2) for cx, cy, r in ((0.5, 0.5, 4 / 64), (y[0], y[1], 5 / 64))]
    else:
        dx, dy = 0.35 * np.sin(float(y[0])), -0.35 * np.cos(float(y[0]))
        tt = np.clip(((xx - 0.5) * dx + (yy - 0.5) * dy) / (dx * dx + dy * dy + 1e-12), 0, 1)
        gaps = [
            np.abs((xx - 0.5 - tt * dx) ** 2 + (yy - 0.5 - tt * dy) ** 2 - (1.6 / 64) ** 2),
            np.abs((xx - 0.5) ** 2 + (yy - 0.5) ** 2 - (2.5 / 64) ** 2),
        ]
    return np.min(gaps, axis=0)


def phase_env_specs(torch, np):
    """(a) No gymnasium, no cv2; the pixel specs on the card against the CPU;
    ImageTransform against numpy. Returns the report."""
    import importlib.util

    from sheeprl_tpu_torch.envs.jittable_pixels import _compiled
    from sheeprl_tpu_torch.envs.wrappers import ImageTransform

    found = {name: importlib.util.find_spec(name) is not None for name in ("gymnasium", "cv2")}
    print("phase 11 (a) find_spec " + json.dumps(found), flush=True)
    report = {"find_spec": found, "specs": {}}
    rng = np.random.default_rng(SEED)
    for env_id in ("PixelPendulum-v0", "PixelPointmass-v0"):
        spec = _compiled(env_id, 64)
        state = spec.init(torch.Generator().manual_seed(SEED), SPEC_ENVS)
        worst, differing, t0 = 0.0, 0, time.perf_counter()
        for _ in range(SPEC_STEPS):
            action = torch.from_numpy(rng.uniform(-1.5, 1.5, (SPEC_ENVS, spec.action_dim)).astype(np.float32))
            cuda_state, cuda_out = spec.step({k: v.cuda() for k, v in state.items()}, action.cuda())
            next_state, out = spec.step(state, action)
            got, want = cuda_state["y"].cpu(), next_state["y"]
            err = ((got - want).abs() / want.abs().clamp(min=1.0)).max().item()
            worst = max(worst, err)
            if (
                err > SPEC_TOL
                or not torch.equal(cuda_state["t"].cpu(), next_state["t"])
                or not torch.allclose(cuda_out.reward.cpu(), out.reward, atol=SPEC_TOL, rtol=SPEC_TOL)
                or not torch.equal(cuda_out.terminated.cpu(), out.terminated)
                or not torch.equal(cuda_out.truncated.cpu(), out.truncated)
            ):
                raise AssertionError(f"{env_id}: the card's step differs from the CPU's (state error {err})")
            diff = (cuda_out.obs.cpu() != out.obs).any(-1).numpy()
            ys = next_state["y"].numpy()
            for b in np.nonzero(diff.any(axis=(1, 2)))[0]:
                if not np.all(edge_gap(np, env_id, ys[b], 64)[diff[b]] <= EDGE_TOL):
                    raise AssertionError(f"{env_id}: frame {b} differs off a mask edge")
            differing += int(diff.sum())
            state = next_state
        share = differing / (SPEC_STEPS * SPEC_ENVS * 64 * 64)
        if share > EDGE_SHARE:
            raise AssertionError(f"{env_id}: {differing} pixels differ ({share:.2e} of them)")
        report["specs"][env_id] = {
            "envs": SPEC_ENVS, "steps": SPEC_STEPS, "max_state_err": worst, "differing_pixels": differing,
            "differing_share": share, "seconds": time.perf_counter() - t0,
        }
    # ImageTransform 128 -> 64, grayscale: cv2's 2x2 mean (round half up) and
    # its 15-bit RGB2GRAY, written out here in plain numpy
    spec = _compiled("PixelPendulum-v0", 128)
    frames = spec.observation(spec.init(torch.Generator().manual_seed(SEED), 64)).numpy()
    frames = (frames.astype(np.int64) + rng.integers(0, 40, frames.shape)).clip(0, 255).astype(np.uint8)
    transform = ImageTransform.__new__(ImageTransform)
    transform._screen_size, transform._grayscale = 64, True
    got = np.stack([transform._transform(f) for f in frames])
    mean = (frames.reshape(64, 64, 2, 64, 2, 3).astype(np.int64).sum(axis=(2, 4)) + 2) >> 2
    want = ((mean[..., 0] * 9798 + mean[..., 1] * 19235 + mean[..., 2] * 3735 + (1 << 14)) >> 15).astype(np.uint8)[..., None]
    if got.shape != (64, 64, 64, 1) or not np.array_equal(got, want):
        raise AssertionError(f"ImageTransform 128 -> 64 gray: shape {got.shape}, {int((got != want).sum())} values differ")
    report["image_transform"] = {"frames": 64, "from": 128, "to": 64, "grayscale": True, "bit_equal": True}
    print("phase 11 (a) specs " + json.dumps(report), flush=True)
    return report


def vector_ms(np, cfg, backend: str) -> float:
    """Host ms per ``step`` of ``cfg``'s vector env on ``backend`` (4 envs,
    random actions, after a warm-up)."""
    from sheeprl_tpu_torch.envs.factory import build_vector_env

    cfg["env"]["backend"] = backend
    envs = build_vector_env(cfg, 0, None, restart_on_exception=True)
    try:
        space = envs.single_action_space
        rng = np.random.default_rng(SEED)
        shape = (envs.num_envs, *space.shape)
        draw = (lambda: rng.integers(0, space.n, envs.num_envs)) if not space.shape else (lambda: rng.uniform(-1, 1, shape).astype(np.float32))
        envs.reset(seed=SEED)
        for _ in range(20):
            envs.step(draw())
        actions = [draw() for _ in range(VECTOR_STEPS)]
        t0 = time.perf_counter()
        for a in actions:
            envs.step(a)
        return 1e3 * (time.perf_counter() - t0) / VECTOR_STEPS
    finally:
        envs.close()


def cli_run_capturing(torch, fg, argv: list, patches=()) -> tuple:
    """``cli.run(argv)`` in this process with ``patches`` (``(target, name,
    value)``) applied, its printing kept apart; returns (main's report,
    heartbeat windows, the replay buffer, the world model, wrapper calls,
    bf16-x calls)."""
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.obs.span import span

    out, beats, buffers, models = {}, [], [], []
    real_main, real_beat, real_make, real_build = dv3.main, dv3.log_sps_and_heartbeat, dv3.make_sequential_replay, dv3.build_agent

    def keep(fabric, cfg):
        out.update(real_main(fabric, cfg))

    def beat(logger, **kw):
        # the window's span seconds, read before the heartbeat resets them
        window = {} if span.disabled else {k: v for k, v in span.compute().items() if v == v}
        beats.append({**kw, "timer_window": window})
        real_beat(logger, **kw)

    def make(*a, **kw):
        buffers.append(real_make(*a, **kw))
        return buffers[-1]

    def build(*a, **kw):
        models.append(real_build(*a, **kw))
        return models[-1]

    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        for target, name, value in (
            (dv3, "main", keep), (dv3, "log_sps_and_heartbeat", beat), (dv3, "make_sequential_replay", make),
            (dv3, "build_agent", build), *patches,
        ):
            stack.enter_context(mock.patch.object(target, name, value))
        stack.enter_context(contextlib.redirect_stdout(buf))
        # ---- the main path: counts at 0 just before, read just after ----
        fg.reset_launch_count()
        cli.run(argv)
        torch.cuda.synchronize()
        calls, bf16_calls = fg.launch_count, fg.bf16_x_launch_count
        # ------------------------------------------------------------------
    return out, beats, buffers[0], models[0][0], calls, bf16_calls


def main_path_launches(out: dict, calls: int) -> int:
    """B1 launches of a main() run: the wrapper's calls outside capture plus
    the captured calls times their replays."""
    captured = sum(g["captured_launches"] for g in out["graphs"])
    return calls - captured + sum(g["captured_launches"] * g["replays"] for g in out["graphs"])


def phase_env_pipeline(torch, np, fg, tmp: str):
    """(a) the specs and ImageTransform; (b) Dreamer-V3 S on PixelPendulum
    through the CLI with action repeat 2 on the async backend; (c) the
    grayscale/resize path and the restart drill on the ring; host ms per
    vector-env step, sync and async. Returns ({path: B1 launches}, report)."""
    import re

    from sheeprl_tpu_torch.configs import compose
    from sheeprl_tpu_torch.envs.wrappers import RestartOnException
    from sheeprl_tpu_torch.utils.logger import read_scalars

    import importlib

    # the env target below is imported by name: this module as ``chip_smoke``
    flaky = importlib.import_module("chip_smoke").FlakyPixelEnv
    t11 = time.perf_counter()
    report = {"card": card_line(), "specs": phase_env_specs(torch, np)}
    # host ms per vector-env step at 4 envs, sync and async in turns
    vector = {}
    for env in ("pixel_pendulum", "pixel_catcher"):
        for backend in ("sync", "async", "async", "sync"):
            vector.setdefault(env, {}).setdefault(backend, []).append(vector_ms(np, compose("S", env=env, overrides={"seed": SEED}), backend))
    report["host_ms_per_vector_step"] = vector
    print("phase 11 vector_envs " + json.dumps(vector), flush=True)

    # (b) PixelPendulum, action repeat 2, async, through the CLI; then the
    # same on the sync backend, for the env's share of the loop
    runs = {}
    for backend in BACKEND_ORDER:
        args = {"seed": SEED, **PENDULUM_ARGS, "env.backend": backend, "metric.log_every": 64, "log_base_dir": f"{tmp}/logs",
                "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl", "run_name": f"pendulum_{backend}"}
        argv = ["exp=dreamer_v3", "env=pixel_pendulum"] + [f"{k}={v}" for k, v in args.items()]
        out, beats, _, _, calls, bf16_calls = cli_run_capturing(torch, fg, argv)
        launches = main_path_launches(out, calls)
        version = f"{tmp}/logs/dreamer_v3/PixelPendulum-v0/pendulum_{backend}/version_0"
        text = open(f"{version}/config.yaml").read()
        bare = re.findall(r"[:\[,]\s*(-?\d+[eE][-+]?\d+)", text)
        tags = {tag for _, tag, _ in read_scalars(glob_one(f"{version}/events.out.tfevents.*"))}
        beat_env_steps = sum(b["env_steps"] for b in beats)
        policy_steps = out["env_steps"]
        spans = {}
        for b in beats:
            for k, v in b["timer_window"].items():
                spans[k] = spans.get(k, 0.0) + v
        run = {
            "argv": argv[1:],
            "policy_steps": policy_steps,
            "env_steps": beat_env_steps,
            "seconds": out["seconds"],
            "env_steps_per_s": beat_env_steps / out["seconds"],
            "policy_steps_per_s": policy_steps / out["seconds"],
            "gradient_steps": out["gradient_steps"],
            "gradient_steps_per_s": out["gradient_steps"] / out["seconds"],
            "span_seconds": spans,
            "train_seconds_device": out["train_seconds"],
            "fused_gru_wrapper_calls": calls,
            "fused_gru_bf16_x_calls": bf16_calls,
            "fused_gru_launches": launches,
            "test_cumulative_reward": out["test_cumulative_reward"],
            "test_steps": out["test_steps"],
            "config_floats_without_a_dot": bare,
            "config_floats": len(re.findall(r"-?\d+\.\d+[eE][-+]\d+", text)),
        }
        runs[backend] = run
        print(f"phase 11 (b) pendulum {backend} " + json.dumps(run), flush=True)
        if (
            beat_env_steps != 2 * policy_steps
            or policy_steps != LOOP_CUTS["algo.total_steps"]
            or out["gradient_steps"] == 0
            or bf16_calls != calls
            or out["test_steps"] != 100
            or not np.isfinite(out["test_cumulative_reward"])
            or "Test/cumulative_reward" not in tags
            or bare
            or not all(np.isfinite(v) for v in out["metrics"].values())
        ):
            raise AssertionError(f"phase 11 (b) {backend}: {run}")
    report["pendulum"] = runs["async"]
    report["pendulum_sync"] = runs["sync"]
    launches_b = runs["async"]["fused_gru_launches"] + runs["sync"]["fused_gru_launches"]

    # (c) PixelPointmass at 128, resized to 64 and grayed, one env crash, the ring
    flaky.crashes = 0
    args = {"seed": SEED, **RESTART_CUTS, "env.wrapper.size": 128, "env.grayscale": True, "env.backend": "sync",
            "env.wrapper._target_": "chip_smoke.FlakyPixelEnv", "log_base_dir": f"{tmp}/logs",
            "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl", "run_name": "restart"}
    argv = ["exp=dreamer_v3", "env=pixel_pointmass"] + [f"{k}={v}" for k, v in args.items()]
    from sheeprl_tpu_torch.data.device_buffer import DeviceReplayBuffer

    amends = []
    real_amend = DeviceReplayBuffer.amend_last

    def amend(self, env_idx, **flags):
        amends.append((env_idx, int((self._pos[env_idx] - 1) % self._buffer_size), flags))
        real_amend(self, env_idx, **flags)

    patches = ((RestartOnException, "sleep", staticmethod(lambda seconds: None)), (DeviceReplayBuffer, "amend_last", amend))
    out, _, rb, wm, calls, bf16_calls = cli_run_capturing(torch, fg, argv, patches)
    launches_c = main_path_launches(out, calls)
    conv = next(m for m in wm.modules() if isinstance(m, torch.nn.Conv2d))
    encoder_input = [conv.in_channels, *rb._pixels["rgb"].shape[-3:-1]] if hasattr(rb, "_pixels") else None
    restart = {
        "argv": argv[1:],
        "replay_buffer": out["replay_buffer"],
        "crashes": flaky.crashes,
        "amend_last_calls": [(e, slot, f) for e, slot, f in amends],
        "encoder_input_chw": encoder_input,
        "gradient_steps": out["gradient_steps"],
        "fused_gru_launches": launches_c,
        "fused_gru_bf16_x_calls": bf16_calls,
        "seconds": out["seconds"],
    }
    if len(amends) == 1:
        env_idx, slot, _ = amends[0]
        row = lambda k, i: float(rb._bufs[k][env_idx, i % rb.buffer_size].reshape(-1)[0])  # noqa: E731
        restart["amended_row"] = {k: row(k, slot) for k in ("terminated", "truncated", "is_first")}
        restart["next_row_is_first"] = row("is_first", slot + 1)
    report["restart"] = restart
    print("phase 11 (c) restart " + json.dumps(restart), flush=True)
    if (
        flaky.crashes != 1
        or len(amends) != 1
        or out["replay_buffer"] != "device"
        or encoder_input != [1, 64, 64]
        or restart["amended_row"] != {"terminated": 0.0, "truncated": 1.0, "is_first": 0.0}
        or restart["next_row_is_first"] != 1.0
        or out["gradient_steps"] == 0
        or bf16_calls != calls
    ):
        raise AssertionError(f"phase 11 (c): {restart}")
    report["seconds"] = time.perf_counter() - t11
    print(f"phase 11 took {report['seconds']:.1f} s", flush=True)
    return {"pendulum_cli_async_and_sync": launches_b, "pointmass_restart_cli": launches_c}, report


def glob_one(pattern: str) -> str:
    import glob

    found = glob.glob(pattern)
    if len(found) != 1:
        raise AssertionError(f"want one file at {pattern}, found {found}")
    return found[0]


# --------------------------------------------------------------------------- #
# phase 12: PPO (host loop, fused on-device rollout, NatureCNN) and
# Dreamer-V3 at bf16-true
# --------------------------------------------------------------------------- #

# the PPO models of 12(a): exp=ppo (CartPole-v1's 4-vector, 2 actions, 4
# envs) and exp=ppo_atari's NatureCNN on PixelCatcher (64x64x3, 3 actions,
# 8 envs), each at its exp's rollout, batch and epochs
PPO_MODELS = {
    "mlp_cartpole": (["exp=ppo"], {"state": ((4,), "float32")}, 2),
    "nature_cnn_pixel_catcher": (["exp=ppo_atari", "env=pixel_catcher", "env.id=pixel_catcher"], {"rgb": ((64, 64, 3), "uint8")}, 3),
}
# captured against eager: the same kernels in both, max |diff| relative to
# the parameter's largest element, after PPO_PARITY_UPDATES updates
PPO_UPDATE_BOUND = 1e-5
PPO_PARITY_UPDATES = 3
PPO_TIMED = 10
# the CLI runs of 12(b)-(d): a few updates each
PPO_CLI_UPDATES = 6
PPO_FUSED_ENVS = ((4, 64), (64, 1024))  # (env.num_envs, per_rank_batch_size): 8 minibatches each
PPO_CNN_UPDATES = 4


def ppo_cfg(*overrides):
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.utils import dotdict

    return dotdict(compose("config", [*overrides, f"seed={SEED}", "env.capture_video=False"]))


def ppo_update_models(torch, np, model: str, precision: str = BF16):
    """The agent, its optimizer, the train generator and the update of
    12(a) (PPO) or 13(a) (A2C) on the card (seeded weights), with its
    static inputs: one rollout of the exp's shape drawn from a seeded numpy
    generator."""
    from sheeprl_tpu_torch.algos.a2c import a2c
    from sheeprl_tpu_torch.algos.ppo import ppo
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.ops.optim import build_optimizer

    exp, obs, n_actions = {**PPO_MODELS, **A2C_MODELS, **CLASSIC_PPO_MODELS}[model]
    cfg = ppo_cfg(*exp, f"fabric.precision={precision}")
    algo = cfg.algo
    space = spaces.Dict({k: spaces.Box(0, 255, shape, np.dtype(dt)) for k, (shape, dt) in obs.items()})
    agent, _ = build_agent((n_actions,), False, cfg, space, device="cuda")
    steps, envs = int(algo.rollout_steps), int(cfg.env.num_envs)
    opt = build_optimizer(list(agent.parameters()), algo.optimizer, float(algo.max_grad_norm or 0.0))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    make_local_train = a2c.make_local_train if algo.name == "a2c" else ppo.make_local_train
    local_train = make_local_train(agent, opt, cfg, list(obs), steps * envs, gen)
    update = ppo.make_update_fn(agent, local_train, cfg, list(obs))
    rng = np.random.default_rng(SEED)
    inputs = {}
    for k, (shape, dt) in obs.items():
        draw = rng.integers(0, 256, (steps + 1, envs, *shape)) if dt == "uint8" else rng.standard_normal((steps + 1, envs, *shape))
        inputs[k] = torch.from_numpy(draw[:steps].astype(dt)).cuda()
        inputs[f"next/{k}"] = torch.from_numpy(draw[steps].astype(dt)).cuda()
    inputs["actions"] = torch.from_numpy(np.eye(n_actions, dtype=np.float32)[rng.integers(0, n_actions, (steps, envs))]).cuda()
    for k in ("values", "logprobs", "rewards"):
        inputs[k] = torch.from_numpy(rng.standard_normal((steps, envs, 1)).astype(np.float32)).cuda()
    inputs["logprobs"] = -inputs["logprobs"].abs() - 0.5
    inputs["dones"] = torch.from_numpy((rng.random((steps, envs, 1)) < 0.02).astype(np.float32)).cuda()
    inputs["coefs"] = torch.tensor([float(algo.get("clip_coef", 0.0)), float(algo.get("ent_coef", 0.0))], device="cuda")
    return cfg, agent, opt, gen, update, inputs


def captured_against_eager(torch, build, label: str, eager_timed: int = 3) -> dict:
    """One update built twice by ``build() -> (cfg, agent, opt, gen,
    update, inputs)`` from the same seeds: the first captured as one CUDA
    graph (``CapturedStep``), the second run eagerly on the card with the
    first's weights; after ``PPO_PARITY_UPDATES`` updates every parameter
    and optimizer state tensor within ``PPO_UPDATE_BOUND`` of eager
    (relative to its largest element; bit-equality reported), one capture;
    ms an update replayed and eager (CUDA events) and a profiler window over
    two replays."""
    from sheeprl_tpu_torch.algos.ppo.ppo import opt_state_tensors
    from sheeprl_tpu_torch.ops import graph

    cfg, g_agent, g_opt, g_gen, g_update, inputs = build()
    _, e_agent, e_opt, _, e_update, _ = build()
    e_agent.load_state_dict(g_agent.state_dict())
    captures = graph.capture_count
    fn = graph.CapturedStep(g_update, inputs, opt_state_tensors(g_agent, g_opt), g_gen)
    for _ in range(PPO_PARITY_UPDATES):
        got = fn()
        want = e_update(inputs)
    torch.cuda.synchronize()
    # the optimizer's float state (its step count last, an integer)
    pairs = list(zip(g_agent.parameters(), e_agent.parameters())) + list(zip(g_opt.state_tensors()[:-1], e_opt.state_tensors()[:-1]))
    rel = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in pairs]
    bit_equal = all(torch.equal(a, b) for a, b in pairs) and bool(torch.equal(got, want))
    n_params = len(list(g_agent.parameters()))
    metric_err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    ms = step_ms(torch, fn, PPO_TIMED)
    eager_ms = step_ms(torch, lambda: e_update(inputs), eager_timed)
    prof = profile_replays(torch, fn, 2, top=5)
    row = {
        "param_max_rel_err": max(rel[:n_params]),
        # SGD without momentum keeps no float state
        "optimizer_state_max_rel_err": max(rel[n_params:], default=0.0),
        "metric_max_rel_err": metric_err,
        "bit_equal": bit_equal,
        "optimizer_steps": int(g_opt.count),
        "ms_per_update_replayed": ms,
        "ms_per_update_eager": eager_ms,
        "replays": fn.replays,
        "captures": graph.capture_count - captures,
        "profile": {k: prof[k] for k in ("wall_ms_per_replay", "device_busy_ms_per_replay", "device_idle_share", "kernels_per_replay", "top_kernels_ms_per_replay")},
    }
    if not (max(rel) <= PPO_UPDATE_BOUND and metric_err <= PPO_UPDATE_BOUND and torch.isfinite(got).all()):
        raise AssertionError(f"{label}: the captured update against eager: {row}")
    if row["captures"] != 1:
        raise AssertionError(f"{label}: {row['captures']} captures, want 1")
    return row


def phase_ppo_update(torch, np):
    """(a) the PPO update captured as one CUDA graph (``CapturedStep``)
    against the same update run eagerly on the card, from the same weights
    and train-generator state, at bf16-mixed (:func:`captured_against_eager`)."""
    report = {"card": card_line(), "bound": PPO_UPDATE_BOUND}
    with cudnn_deterministic(torch):
        for model in PPO_MODELS:
            row = captured_against_eager(torch, lambda: ppo_update_models(torch, np, model), f"12(a) {model}")
            cfg = ppo_cfg(*PPO_MODELS[model][0])
            algo = cfg.algo
            row["rollout"] = [int(algo.rollout_steps), int(cfg.env.num_envs)]
            row["minibatch_steps_per_update"] = int(algo.update_epochs) * (int(algo.rollout_steps) * int(cfg.env.num_envs) // int(algo.per_rank_batch_size))
            report[model] = row
    print("phase 12(a) ppo_update " + json.dumps(report), flush=True)
    return report


def ppo_cli(torch, tmp: str, run_name: str, overrides: list, module=None, gates=()) -> tuple:
    """``cli.run`` of ``overrides`` in this process, its printing kept apart;
    returns (main's report, the fused_fallback reasons, seconds). ``module``
    is the algorithm's (PPO's by default): its ``main`` is wrapped, and the
    ``fused_fallback`` of PPO's gate, of the module and of ``gates`` are
    counted."""
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.ppo import ppo

    module = module or ppo
    out, fallbacks = {}, []
    real_main, real_fallback = module.main, ppo.fused_fallback

    def keep(fabric, cfg):
        out.update(real_main(fabric, cfg))

    def fallback(reason, detail):
        fallbacks.append(reason)
        real_fallback(reason, detail)

    gates = {ppo, *gates, *((module,) if hasattr(module, "fused_fallback") else ())}

    argv = [
        *overrides,
        f"seed={SEED}",
        "env.capture_video=False",
        f"log_base_dir={tmp}/logs",
        f"metric.telemetry.runs_jsonl={tmp}/RUNS.jsonl",
        f"run_name={run_name}",
    ]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(module, "main", keep))
        for gate in gates:
            stack.enter_context(mock.patch.object(gate, "fused_fallback", fallback))
        stack.enter_context(contextlib.redirect_stdout(buf))
        cli.run(argv)
    torch.cuda.synchronize()
    return out, fallbacks, time.perf_counter() - t0


def ppo_run_report(out: dict, seconds: float) -> dict:
    ms = [s * 1e3 for s in out["update_seconds"]]
    # the first update captures the graphs: the steady rate is the median
    # of the later updates' host seconds, rollout included
    later = sorted(out["update_wall_seconds"][1:])
    return {
        "updates": out["updates"],
        "env_steps": out["env_steps"],
        "env_steps_per_s": out["env_steps"] / out["seconds"],
        "env_steps_per_s_steady": out["env_steps"] / out["updates"] / later[len(later) // 2] if later else None,
        "update_wall_s": out["update_wall_seconds"],
        "loop_seconds": out["seconds"],
        "process_seconds": seconds,
        "ms_per_update": ms,
        # the first update captures the graph
        "ms_per_update_steady": float(sorted(ms[1:])[len(ms[1:]) // 2]) if len(ms) > 1 else ms[0],
        "env_span_share": out["env_seconds"] / out["seconds"],
        "replays": out["replays"],
        "test_cumulative_reward": out["test_cumulative_reward"],
        "test_steps": out["test_steps"],
        "metrics": out["metrics"],
    }


def phase_ppo_cli(torch, tmp: str):
    """(b) ``exp=ppo`` (CartPole-v1 host envs, ``sync``, 4 envs,
    bf16-mixed) through the CLI for ``PPO_CLI_UPDATES`` updates; (c) the
    same with ``algo.fused_rollout=True`` at 4 and 64 envs: one replay an
    update, no ``fused_fallback``; (d) ``exp=ppo_atari``'s NatureCNN on
    PixelCatcher (``sync``, 8 envs). Env-steps/s, ms an update, the env
    span's share and the test episode's return of each."""
    report = {"card": card_line()}
    base = ["exp=ppo", "env.backend=sync", "metric.log_level=1"]
    steps = 128 * 4 * PPO_CLI_UPDATES
    out, fallbacks, seconds = ppo_cli(torch, tmp, "ppo_host", [*base, f"algo.total_steps={steps}"])
    report["host_loop"] = ppo_run_report(out, seconds)
    if out["fused_rollout"] or out["updates"] != PPO_CLI_UPDATES or not all(map(math.isfinite, out["metrics"].values())):
        raise AssertionError(f"12(b) exp=ppo: {report['host_loop']}")
    print("phase 12(b) ppo_host_loop " + json.dumps(report["host_loop"]), flush=True)
    report["fused"] = {}
    for envs, batch in PPO_FUSED_ENVS:
        steps = 128 * envs * PPO_CLI_UPDATES
        args = [*base, "algo.fused_rollout=True", f"env.num_envs={envs}", f"algo.per_rank_batch_size={batch}", f"algo.total_steps={steps}"]
        out, fallbacks, seconds = ppo_cli(torch, tmp, f"ppo_fused_{envs}", args)
        row = ppo_run_report(out, seconds)
        row["fused_fallback"] = fallbacks
        row["replays_per_update"] = out["replays"] / out["updates"]
        report["fused"][envs] = row
        print(f"phase 12(c) ppo_fused_{envs}_envs " + json.dumps(row), flush=True)
        if fallbacks or not out["fused_rollout"] or out["replays"] != out["updates"] or out["updates"] != PPO_CLI_UPDATES:
            raise AssertionError(f"12(c) fused rollout at {envs} envs: {row}")
    steps = 128 * 8 * PPO_CNN_UPDATES
    args = ["exp=ppo_atari", "env=pixel_catcher", "env.id=pixel_catcher", "env.backend=sync", "metric.log_level=1", f"algo.total_steps={steps}"]
    out, fallbacks, seconds = ppo_cli(torch, tmp, "ppo_cnn", args)
    report["nature_cnn"] = ppo_run_report(out, seconds)
    print("phase 12(d) ppo_nature_cnn_pixel_catcher " + json.dumps(report["nature_cnn"]), flush=True)
    if out["updates"] != PPO_CNN_UPDATES or not all(map(math.isfinite, out["metrics"].values())):
        raise AssertionError(f"12(d) NatureCNN on PixelCatcher: {report['nature_cnn']}")
    return report


def phase_bf16_true(torch, np, fg, rb, obs_space, actions_dim, is_continuous):
    """(e) one Dreamer-V3 S train step at bf16-true against the same step
    at bf16-mixed on the card, the same weights and batch, the smooth
    samplers: metrics, Moments and every gradient bit-equal (the JAX
    modules fix fp32 parameters, so both precisions compute the same), B1
    called 80 times a step with a bf16 x in each. Returns B1's launches."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch

    batch = to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], torch.device("cuda"))
    per_step = SCAN_CALLS + IMAGINE_CALLS
    out, launches = {}, 0
    with deterministic(), cudnn_deterministic(torch):
        mixed, _, _ = train_models(torch, train_cfg("pixel_catcher", precision=BF16), obs_space, actions_dim, is_continuous)
        states = snapshot(mixed)
        for precision in (BF16, "bf16-true"):
            models, step, _ = train_models(torch, train_cfg("pixel_catcher", precision=precision), obs_space, actions_dim, is_continuous, states)
            if models["wm"].dtype != torch.bfloat16 or any(p.dtype != torch.float32 for p in models["wm"].parameters()):
                raise AssertionError(f"Dreamer-V3 at {precision}: bf16 compute and fp32 parameters expected")
            grads = {}
            metrics, calls = one_step(torch, fg, step, batch, grads)
            if (calls, fg.bf16_x_launch_count) != (per_step, per_step):
                raise AssertionError(f"{precision}: {calls} B1 calls, {fg.bf16_x_launch_count} with a bf16 x (want {per_step})")
            launches += calls
            out[precision] = (metrics, grads, snapshot(models))
    (m_a, g_a, s_a), (m_b, g_b, s_b) = out[BF16], out["bf16-true"]
    equal = {
        "metrics": bool(torch.equal(m_a, m_b)),
        **{f"{k}_grads": all(torch.equal(a, b) for a, b in zip(g_a[k], g_b[k])) for k in g_a},
        "params_after_step": all(torch.equal(s_a[k][n], s_b[k][n]) for k in s_a for n in s_a[k]),
    }
    report = {"card": card_line(), "bit_equal": equal, "fused_gru_calls": launches, "fused_gru_bf16_x_calls_per_step": per_step}
    print("phase 12(e) dv3_bf16_true " + json.dumps(report), flush=True)
    if not all(equal.values()):
        raise AssertionError(f"12(e) Dreamer-V3 bf16-true is not bit-equal to bf16-mixed: {equal}")
    return launches


# --------------------------------------------------------------------------- #
# phase 13: A2C (RMSProp) and recurrent PPO (the LSTM, the sequence update,
# the fused recurrent rollout)
# --------------------------------------------------------------------------- #

# exp=a2c at full width (64 x 2 tanh, 5 steps x 4 envs on CartPole-v1)
A2C_MODELS = {"a2c_cartpole": (["exp=a2c"], {"state": ((4,), "float32")}, 2)}
# of 20 env steps each (exp=a2c: 1250; 250 until phase 18 needed the time)
A2C_CLI_UPDATES = 125
# exp=ppo_recurrent at full width: LSTM 64, 16 envs x 512 steps, sequences
# of 16, 8 minibatches, 8 epochs; one seeded rollout with episodes of about
# 1 / RPPO_DONE_RATE steps
RPPO_DONE_RATE = 0.05
RPPO_PLAYER_STEPS = 64
RPPO_PLAYER_TOL = 1e-5
RPPO_CLI_UPDATES = 2  # of 8192 env steps each (exp=ppo_recurrent: 49)


def rppo_update_models(torch, np, windows: bool, precision: str = BF16):
    """The recurrent agent, its AdamW, the train generator and one update at
    ``exp=ppo_recurrent`` widths on the card (seeded weights) over one
    seeded rollout: the host path's (the sequences cut at the episode ends
    and padded, ``make_update_fn``) or, with ``windows``, the fused path's
    (GAE, fixed windows of 16 that cross episode ends, the update replaying
    the resets), with its static inputs."""
    from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent as rp
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.ops.math import gae
    from sheeprl_tpu_torch.ops.optim import build_optimizer
    from sheeprl_tpu_torch.ops.rollout_scan import fixed_windows

    cfg = ppo_cfg("exp=ppo_recurrent", f"fabric.precision={precision}")
    algo = cfg.algo
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    agent, _ = build_agent((2,), False, cfg, space, device="cuda")
    opt = build_optimizer(list(agent.parameters()), algo.optimizer, float(algo.max_grad_norm or 0.0))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    steps, envs, hidden = int(algo.rollout_steps), int(cfg.env.num_envs), int(algo.rnn.lstm.hidden_size)
    seq_len, num_batches = int(algo.per_rank_sequence_length), int(algo.per_rank_num_batches)
    local_train = rp.make_local_train(agent, opt, cfg, ["state"], gen, sequence_dones=windows)
    rng = np.random.default_rng(SEED)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    onehot = lambda shape: np.eye(2, dtype=np.float32)[rng.integers(0, 2, shape)]  # noqa: E731
    dones = (rng.random((steps, envs, 1)) < RPPO_DONE_RATE).astype(np.float32)
    inputs = {
        "state": cuda(rng.standard_normal((steps, envs, 4)).astype(np.float32)),
        "actions": cuda(onehot((steps, envs))),
        "prev_actions": cuda(onehot((steps, envs))),
        "values": cuda(rng.standard_normal((steps, envs, 1)).astype(np.float32)),
        "logprobs": cuda(-np.abs(rng.standard_normal((steps, envs, 1))).astype(np.float32) - 0.5),
        "rewards": cuda(rng.standard_normal((steps, envs, 1)).astype(np.float32)),
        "dones": cuda(dones),
        "prev_hx": cuda(0.5 * rng.standard_normal((steps, envs, hidden)).astype(np.float32)),
        "prev_cx": cuda(0.5 * rng.standard_normal((steps, envs, hidden)).astype(np.float32)),
        "next/state": cuda(rng.standard_normal((envs, 4)).astype(np.float32)),
        "next/prev_actions": cuda(onehot(envs)),
        "next/hx": cuda(0.5 * rng.standard_normal((envs, hidden)).astype(np.float32)),
        "next/cx": cuda(0.5 * rng.standard_normal((envs, hidden)).astype(np.float32)),
        "coefs": torch.tensor([float(algo.clip_coef), float(algo.ent_coef)], device="cuda"),
    }
    if not windows:
        layout = rp.sequence_layout(dones[..., 0], seq_len, num_batches)
        for k, v in zip(("seq/index", "seq/mask", "seq/start", "seq/valid"), layout):
            inputs[k] = cuda(v)
        return cfg, agent, opt, gen, rp.make_update_fn(agent, local_train, cfg, ["state"]), inputs
    gamma, lmbda = float(algo.gamma), float(algo.gae_lambda)

    def window_update(d):
        with torch.no_grad():
            nv = agent({"state": d["next/state"][None]}, d["next/prev_actions"][None], d["next/hx"], d["next/cx"])[1][0]
            data = {k: d[k] for k in ("state", "dones", "values", "actions", "logprobs", "rewards", "prev_hx", "prev_cx", "prev_actions")}
            data["returns"], data["advantages"] = gae(d["rewards"], d["values"], d["dones"], nv, gamma, lmbda)
            seq, hx0, cx0 = fixed_windows(data, seq_len)
        return local_train(seq, hx0, cx0, d["coefs"])

    return cfg, agent, opt, gen, window_update, inputs


def phase_a2c_update(torch, np):
    """13(a) the A2C update (GAE and one RMSProp step over the 20-step
    rollout) captured against eager at ``exp=a2c`` widths, bf16-mixed
    (:func:`captured_against_eager`: parameters and RMSProp's ``nu``)."""
    report = {"card": card_line(), "bound": PPO_UPDATE_BOUND}
    with cudnn_deterministic(torch):
        for model in A2C_MODELS:
            report[model] = captured_against_eager(torch, lambda: ppo_update_models(torch, np, model), f"13(a) {model}")
    print("phase 13(a) a2c_update " + json.dumps(report), flush=True)
    return report


def onpolicy_run_checks(label: str, out: dict, fallbacks: list, updates: int, fused: bool) -> None:
    """A CLI run's report: its updates, finite metrics, a test episode, and
    on the fused path one replay an update and no ``fused_fallback``."""
    ok = out["updates"] == updates and all(map(math.isfinite, out["metrics"].values())) and out["test_steps"] > 0
    if fused:
        ok = ok and out["fused_rollout"] and not fallbacks and out["replays"] == out["updates"]
    else:
        ok = ok and not out["fused_rollout"]
    if not ok:
        raise AssertionError(f"{label}: {out['updates']} updates (want {updates}), fused={out['fused_rollout']}, fallbacks={fallbacks}, replays={out['replays']}, metrics={out['metrics']}")


def phase_a2c_cli(torch, tmp: str):
    """13(b) ``exp=a2c`` through ``cli.run`` (CartPole-v1 host envs,
    ``sync``, 4 envs, bf16-mixed) for ``A2C_CLI_UPDATES`` updates, then the
    same with ``algo.fused_rollout=True``: env-steps/s (overall and
    steady) and the test episode of each."""
    from sheeprl_tpu_torch.algos.a2c import a2c

    report = {"card": card_line(), "cuts": {"algo.total_steps": [20 * A2C_CLI_UPDATES, 25000]}}
    base = ["exp=a2c", "env.backend=sync", "metric.log_level=1", f"algo.total_steps={20 * A2C_CLI_UPDATES}"]
    for fused in (False, True):
        out, fallbacks, seconds = ppo_cli(torch, tmp, f"a2c_fused_{fused}", [*base, f"algo.fused_rollout={fused}"], a2c)
        # A2C_CLI_UPDATES updates: their ranges, not every update's numbers
        row = {k: v for k, v in ppo_run_report(out, seconds).items() if k not in ("update_wall_s", "ms_per_update")}
        row["ms_per_update_range"] = [min(out["update_seconds"]) * 1e3, max(out["update_seconds"]) * 1e3]
        row["fused_fallback"] = fallbacks
        row["replays_per_update"] = out["replays"] / max(out["updates"], 1)
        report["fused" if fused else "host_loop"] = row
        print(f"phase 13(b) a2c_{'fused' if fused else 'host_loop'} " + json.dumps(row), flush=True)
        onpolicy_run_checks(f"13(b) exp=a2c fused={fused}", out, fallbacks, A2C_CLI_UPDATES, fused)
    return report


def phase_rppo_update(torch, np):
    """13(c) the recurrent update at ``exp=ppo_recurrent`` widths (bf16-mixed)
    captured against eager on the card, the host path's padded chunks and
    the fused path's fixed windows with resets (:func:`captured_against_eager`),
    with a profiler window over two replays each; then the player's LSTM
    step on the card (its CUDA graph) against the same step on the CPU for
    ``RPPO_PLAYER_STEPS`` steps at fp32, teacher-forced from the CPU's state:
    ``hx'``, ``cx'``, the values and the log-probs within
    ``RPPO_PLAYER_TOL``."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent
    from sheeprl_tpu_torch.envs import spaces

    report = {"card": card_line(), "bound": PPO_UPDATE_BOUND, "rollout": [512, 16], "sequence_length": 16}
    with cudnn_deterministic(torch):
        for name, windows in (("host_padded_chunks", False), ("fused_fixed_windows", True)):
            # one eager update timed: each takes over a second
            row = captured_against_eager(torch, lambda: rppo_update_models(torch, np, windows), f"13(c) {name}", eager_timed=1)
            if not windows:
                _, _, _, _, _, inputs = rppo_update_models(torch, np, False)
                row["sequences_padded"] = int(inputs["seq/mask"].shape[1])
                row["sequences_valid"] = int(inputs["seq/valid"].sum().item())
            report[name] = row
            print(f"phase 13(c) rppo_update_{name} " + json.dumps(row), flush=True)
    cfg = ppo_cfg("exp=ppo_recurrent", f"fabric.precision={FP32}")
    space = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (4,), np.float32)})
    card, player = build_agent((2,), False, cfg, space, device="cuda")
    cpu, _ = build_agent((2,), False, cfg, space, {k: v.cpu() for k, v in card.state_dict().items()}, device="cpu")
    rng = np.random.default_rng(SEED)
    envs, hidden = int(cfg.env.num_envs), card.lstm_hidden_size
    hx, cx, pa = torch.zeros(envs, hidden), torch.zeros(envs, hidden), torch.zeros(envs, 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err = 0.0
    with torch.no_grad():
        for _ in range(RPPO_PLAYER_STEPS):
            obs = {"state": rng.standard_normal((envs, 4)).astype(np.float32)}
            actions, _, logprobs, values, new_hx, new_cx = player.rollout_actions(obs, pa.cuda(), hx.cuda(), cx.cuda(), gen)
            heads, want_values, (want_hx, want_cx) = cpu({"state": torch.from_numpy(obs["state"])[None]}, pa[None], hx, cx)
            want_logprobs = torch.log_softmax(heads[0][0].float(), -1).gather(-1, actions.cpu().argmax(-1, keepdim=True))
            for got, want in ((new_hx, want_hx), (new_cx, want_cx), (values, want_values[0]), (logprobs, want_logprobs)):
                err = max(err, (got.cpu() - want).abs().max().item())
            hx, cx = want_hx, want_cx
            pa = torch.from_numpy(np.eye(2, dtype=np.float32)[rng.integers(0, 2, envs)])
    report["player_lstm_card_vs_cpu"] = {"steps": RPPO_PLAYER_STEPS, "max_abs_err": err, "tol": RPPO_PLAYER_TOL, "replays": player._rollout.replays}
    print("phase 13(c) rppo_player " + json.dumps(report["player_lstm_card_vs_cpu"]), flush=True)
    if not err <= RPPO_PLAYER_TOL:
        raise AssertionError(f"13(c) the player's LSTM step on the card against the CPU: {err} > {RPPO_PLAYER_TOL}")
    return report


def phase_rppo_cli(torch, tmp: str):
    """13(d) ``exp=ppo_recurrent`` through ``cli.run`` (CartPole-v1 host
    envs, ``sync``, 16 envs x 512 steps, bf16-mixed), cut to
    ``RPPO_CLI_UPDATES`` updates: env-steps/s overall and steady, ms an
    update, the captures made (one for each padded sequence count) and the
    env span's share; then ``algo.fused_rollout=True``: one replay an update,
    no ``fused_fallback``."""
    from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent

    steps = 8192 * RPPO_CLI_UPDATES
    report = {"card": card_line(), "cuts": {"algo.total_steps": [steps, 409000]}}
    base = ["exp=ppo_recurrent", "env.backend=sync", "metric.log_level=1", f"algo.total_steps={steps}"]
    for fused in (False, True):
        out, fallbacks, seconds = ppo_cli(torch, tmp, f"rppo_fused_{fused}", [*base, f"algo.fused_rollout={fused}"], ppo_recurrent)
        row = ppo_run_report(out, seconds)
        row.update(fused_fallback=fallbacks, captures=out["captures"], sequence_counts=out["sequence_counts"])
        row["replays_per_update"] = out["replays"] / max(out["updates"], 1)
        report["fused" if fused else "host_loop"] = row
        print(f"phase 13(d) rppo_{'fused' if fused else 'host_loop'} " + json.dumps(row), flush=True)
        onpolicy_run_checks(f"13(d) exp=ppo_recurrent fused={fused}", out, fallbacks, RPPO_CLI_UPDATES, fused)
    return report


# --------------------------------------------------------------------------- #
# phase 14: SAC, DroQ and SAC-AE
# --------------------------------------------------------------------------- #

# algorithm: (config overrides, gradient steps of the update held against eager)
SAC_MODELS = {
    "sac": (["exp=sac"], 16),
    "droq": (["exp=droq"], 20),
    "sac_ae": (["exp=sac_ae", "env=pixel_pendulum", "env.id=PixelPendulum-v0", "env.frame_stack=3"], 2),
}
SAC_UPDATE_BOUND = 1e-6
SAC_UPDATES = 2  # captured against eager, each on the same batch
SAC_TIMED = 3
# the CLI runs of 14(b): (run, algorithm, overrides); every cut printed
SAC_CLI_RUNS = (
    ("sac_ring", "sac", ["exp=sac", "buffer.device=auto", "algo.total_steps=2000"]),
    ("sac_host", "sac", ["exp=sac", "buffer.device=False", "algo.total_steps=2000"]),
    ("sac_ring_fused_k4", "sac", ["exp=sac", "buffer.device=auto", "algo.fused_gradient_steps=4", "algo.total_steps=2000"]),
    ("droq_ring", "droq", ["exp=droq", "buffer.device=auto", "algo.total_steps=480"]),
    ("droq_host", "droq", ["exp=droq", "buffer.device=False", "algo.total_steps=480"]),
    ("sac_ae_ring", "sac_ae", [*SAC_MODELS["sac_ae"][0], "buffer.device=auto", "buffer.size=20000", "algo.learning_starts=64", "algo.total_steps=160"]),
    ("sac_ae_host", "sac_ae", [*SAC_MODELS["sac_ae"][0], "buffer.device=False", "buffer.size=20000", "algo.learning_starts=64", "algo.total_steps=160"]),
)
# captures a loop may make: two a train function (DroQ's actor update is a
# third function), four for SAC-AE's gate phases
SAC_MAX_CAPTURES = {"sac": 2, "droq": 3, "sac_ae": 4}


def sac_family_trainer(torch, np, name: str, precision: str = BF16):
    """(cfg, trainer) of ``name`` at its exp's widths on the card, seeded
    weights (the same for every call), no fused draws."""
    from sheeprl_tpu_torch.algos.droq.droq import build_droq
    from sheeprl_tpu_torch.algos.sac.sac import build_sac
    from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SCREEN_SIZE, build_sac_ae
    from sheeprl_tpu_torch.envs import spaces

    cfg = ppo_cfg(*SAC_MODELS[name][0], f"fabric.precision={precision}")
    action = spaces.Box(-2.0, 2.0, (1,), np.float32)
    if name == "sac_ae":
        cfg.env.screen_size = SCREEN_SIZE
        obs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, SCREEN_SIZE, SCREEN_SIZE, 3), np.uint8)})
    else:
        obs = spaces.Dict({"state": spaces.Box(-np.inf, np.inf, (3,), np.float32)})
    build = {"sac": build_sac, "droq": build_droq, "sac_ae": build_sac_ae}[name]
    trainer, _ = build(cfg, obs, action, None, torch.device("cuda"), int(cfg.algo.per_rank_batch_size), 0)
    return cfg, trainer


def sac_family_batch(torch, np, trainer, n: int) -> dict:
    """``[n, B, ...]`` of the trainer's batch keys from a seeded generator,
    on the card: uint8 pixels, normal vectors, actions in the bounds, 5%
    terminations."""
    rng = np.random.default_rng(SEED)
    out = {}
    for k, (shape, dt) in trainer.batch_spec().items():
        full = (n, trainer.batch_size, *shape)
        if dt == torch.uint8:
            a = rng.integers(0, 256, full).astype(np.uint8)
        elif k == "actions":
            a = rng.uniform(-2, 2, full).astype(np.float32)
        elif k == "terminated":
            a = (rng.random(full) < 0.05).astype(np.float32)
        else:
            a = rng.standard_normal(full).astype(np.float32)
        out[k] = torch.from_numpy(a).cuda()
    return out


def sac_family_update(torch, trainer, batch: dict, n_steps: int, eager: bool) -> list:
    """One update of ``n_steps`` gradient steps as the loop's train window
    runs it (full chunks, a remainder as one-step replays, DroQ's actor
    update last) on the rows of ``batch``: replayed graphs, or with
    ``eager`` the same step functions called directly. Returns the
    metrics of each call."""
    from sheeprl_tpu_torch.utils.utils import gradient_step_chunks

    out, row = [], 0
    for n in gradient_step_chunks(n_steps, {"gradient_steps_chunk": trainer.chunk}):
        length = n if n == trainer.chunk else 1
        for _ in range(n // length):
            fn = trainer._graph(length, trainer.grad_steps % trainer.period)
            for k, dst in fn.inputs.items():
                dst.copy_(batch[k][row : row + length])
            out.append(fn.step(fn.inputs) if eager else fn())
            row += length
            trainer.grad_steps += length
    if hasattr(trainer, "actor_update"):
        fn = trainer._actor_graph()
        fn.inputs["observations"].copy_(batch["observations"][0])
        out.append(fn.step(fn.inputs) if eager else fn())
    return out


def phase_sac_update(torch, np):
    """14(a) each algorithm's update captured against eager at full width
    (``SAC_MODELS``), bf16-mixed: ``SAC_UPDATES`` updates on the same
    batch from the same weights and generator states, every state tensor
    within ``SAC_UPDATE_BOUND`` (relative to its largest element; bit
    equality reported), the captures, ms a replay of each graph, a profiler
    window, and SAC-AE's FLOPs a gradient step with its MFU."""
    from sheeprl_tpu_torch.obs.flops import count_flops
    from sheeprl_tpu_torch.ops import graph

    report = {"card": card_line(), "bound": SAC_UPDATE_BOUND}
    with cudnn_deterministic(torch):
        for name, (_, n_steps) in SAC_MODELS.items():
            cfg, got = sac_family_trainer(torch, np, name)
            _, want = sac_family_trainer(torch, np, name)
            batch = sac_family_batch(torch, np, got, n_steps)
            captures = graph.capture_count
            for _ in range(SAC_UPDATES):
                g = sac_family_update(torch, got, batch, n_steps, eager=False)
                w = sac_family_update(torch, want, batch, n_steps, eager=True)
            torch.cuda.synchronize()
            pairs = [(a, b) for a, b in zip(got.state_tensors(), want.state_tensors()) if a.is_floating_point()]
            rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in pairs)
            metric_err = max(((a - b).abs() / b.abs().clamp_min(1.0)).max().item() for a, b in zip(g, w))
            bit_equal = all(torch.equal(a, b) for a, b in pairs) and all(torch.equal(a, b) for a, b in zip(g, w))
            row = {
                "widths": {"batch": got.batch_size, "hidden": int(cfg.algo.hidden_size), "critics": int(cfg.algo.critic.n)},
                "gradient_steps_per_update": n_steps,
                "state_max_rel_err": rel,
                "metric_max_rel_err": metric_err,
                "bit_equal": bit_equal,
                "captures": graph.capture_count - captures,
                "graphs": {str(k): {"replays": fn.replays} for k, fn in got.graphs.items()},
            }
            for key, fn in got.graphs.items():
                fn_row = row["graphs"][str(key)]
                fn_row["ms_per_replay"] = step_ms(torch, fn, SAC_TIMED)
                prof = profile_replays(torch, fn, 2, top=5)
                fn_row["profile"] = {k: prof[k] for k in ("wall_ms_per_replay", "device_busy_ms_per_replay", "device_idle_share", "kernels_per_replay", "top_kernels_ms_per_replay")}
            if name == "sac_ae":
                # the FLOPs of the two gate phases' steps, eager: a gradient step is their mean
                flops = [count_flops(fn.step, fn.inputs)[1] for fn in want.graphs.values()]
                per_step = sum(flops) / len(flops)
                ms = sum(r["ms_per_replay"] for r in row["graphs"].values()) / len(row["graphs"])
                row["flops_per_gradient_step"] = per_step
                row["flops_by_phase"] = flops
                row["ms_per_gradient_step_replayed"] = ms
                row["mfu_bf16"] = per_step / (ms / 1e3) / BF16_TC_FLOP_PER_S
            report[name] = row
            print(f"phase 14(a) {name}_update " + json.dumps(row), flush=True)
            if not (rel <= SAC_UPDATE_BOUND and metric_err <= SAC_UPDATE_BOUND and all(torch.isfinite(m).all() for m in g)):
                raise AssertionError(f"14(a) {name}: the captured update against eager: {row}")
            if row["captures"] != len(got.graphs):
                raise AssertionError(f"14(a) {name}: {row['captures']} captures for {len(got.graphs)} graphs")
    return report


def sac_run_report(out: dict, seconds: float) -> dict:
    # the steady rate: the median host seconds of the later half of the
    # updates (every capture and the learning_starts updates before them)
    later = sorted(out["update_wall_seconds"][len(out["update_wall_seconds"]) // 2 :])
    per_update = out["env_steps"] / max(out["updates"], 1)
    windows = sorted(out["window_seconds"])
    return {
        "replay_buffer": out["replay_buffer"],
        "updates": out["updates"],
        "env_steps": out["env_steps"],
        "gradient_steps": out["gradient_steps"],
        "env_steps_per_s": out["env_steps"] / out["seconds"],
        "env_steps_per_s_steady": per_update / later[len(later) // 2] if later else None,
        "loop_seconds": out["seconds"],
        "process_seconds": seconds,
        "env_span_share": out["env_seconds"] / out["seconds"],
        "window_ms_median": 1e3 * windows[len(windows) // 2] if windows else None,
        "captures": out["captures"],
        "replays": out["replays"],
        "fused_gradient_steps": out["fused_gradient_steps"],
        "h2d_bytes_per_gradient_step": out["h2d_bytes"] / max(out["gradient_steps"], 1),
        "test_steps": out["test_steps"],
        "test_cumulative_reward": out["test_cumulative_reward"],
        "metrics": out["metrics"],
    }


def phase_sac_cli(torch, np, tmp: str):
    """14(b) the CLI runs of ``SAC_CLI_RUNS`` through ``cli.run`` (4 envs,
    ``sync``, bf16-mixed); (c) ``cli_eval`` on each algorithm's last
    checkpoint; and where ``buffer.device: auto`` puts SAC-AE's published
    1M transitions."""
    import glob
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.droq import droq
    from sheeprl_tpu_torch.algos.sac import sac
    from sheeprl_tpu_torch.algos.sac_ae import sac_ae
    from sheeprl_tpu_torch.data.device_buffer import estimate_transition_bytes, resolve_device_buffer
    from sheeprl_tpu_torch.envs import spaces

    modules = {"sac": sac, "droq": droq, "sac_ae": sac_ae}
    report = {"card": card_line(), "runs": {}, "evaluations": {}}
    ckpts = {}
    for run, name, overrides in SAC_CLI_RUNS:
        args = [*overrides, "env.backend=sync", "env.num_envs=4", "metric.log_level=1"]
        out, fallbacks, seconds = ppo_cli(torch, tmp, run, args, modules[name], gates=(sac,))
        row = sac_run_report(out, seconds)
        row.update(cuts=overrides, fused_fallback=fallbacks)
        report["runs"][run] = row
        print(f"phase 14(b) {run} " + json.dumps(row), flush=True)
        want_buffer = "device" if "buffer.device=auto" in overrides else "memmap"
        ok = (
            row["replay_buffer"] == want_buffer
            and not fallbacks
            and 0 < out["captures"] <= SAC_MAX_CAPTURES[name]
            and all(map(math.isfinite, out["metrics"].values()))
            and out["test_steps"] > 0
            and out["gradient_steps"] > 0
        )
        if "algo.fused_gradient_steps=4" in overrides:
            ok = ok and out["fused_gradient_steps"] == 4 and out["replays"] == out["train_windows"]
        if not ok:
            raise AssertionError(f"14(b) {run}: {row}")
        ckpts.setdefault(name, sorted(glob.glob(f"{out['log_dir']}/checkpoint/*.ckpt"))[-1])
    for name, ckpt in ckpts.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.evaluation([f"checkpoint_path={ckpt}"])
        text = buf.getvalue()
        reward = [line for line in text.splitlines() if line.startswith("Test - Reward")]
        report["evaluations"][name] = {"checkpoint": ckpt.rsplit("/", 1)[-1], "seconds": time.perf_counter() - t0, "line": reward[-1] if reward else None}
        print(f"phase 14(c) {name}_cli_eval " + json.dumps(report["evaluations"][name]), flush=True)
        if not reward:
            raise AssertionError(f"14(c) cli_eval of {name} played no test episode: {text[-500:]}")
    # exp=sac_ae's published replay: 1M transitions over 4 envs of 2 x 9 x 64 x 64 bytes
    pixels = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64, 3), np.uint8)})
    cfg = ppo_cfg(*SAC_MODELS["sac_ae"][0])
    est = estimate_transition_bytes(pixels, ["rgb"], (1,), int(cfg.buffer.size) // 4, 4, True)
    on_ring = resolve_device_buffer(cfg, "cuda", pixels, (1,), int(cfg.buffer.size) // 4, 4, estimated_bytes=est)
    report["sac_ae_published_replay"] = {"estimated_bytes": est, "device_max_bytes": int(cfg.buffer.device_max_bytes), "ring": on_ring}
    print("phase 14(b) sac_ae_published_replay " + json.dumps(report["sac_ae_published_replay"]), flush=True)
    if on_ring:
        raise AssertionError("14(b) buffer.device=auto put exp=sac_ae's 1M transitions on the card")
    return report


# --------------------------------------------------------------------------- #
# phase 15: the serving tier (python -m sheeprl_tpu_torch serve), serving
# phase 12's PPO checkpoints
# --------------------------------------------------------------------------- #

# the served models: phase 12's exp=ppo MLP (CartPole-v1) and exp=ppo_atari
# NatureCNN (PixelCatcher 64x64x3) runs, by run name
SERVE_RUNS = {"mlp_cartpole": "ppo_host", "nature_cnn_pixel_catcher": "ppo_cnn"}
SERVE_LADDER = (1, 2, 4, 8)  # configs/config.yaml serve.batch_ladder
SERVE_REPLAYS = 200  # back-to-back replays a rung between CUDA events
SERVE_ROUND_TRIPS = 100  # stage, copy in, replay, copy out, synchronize
SERVE_REQUESTS = 100  # sequential ServeClient.infer calls at batch 1
SERVE_LOAD_S = 5.0  # each CLI load run (closed loop, then open loop)
SERVE_OPEN_RATE_HZ = 1000.0
SERVE_SWAP_TRAFFIC_S = 1.0  # traffic before and after the hot swap
SERVE_CRASH_REQUESTS = 10  # replica_crash at batch 5 of one replica


def serve_ckpt_dir(tmp: str, run_name: str) -> str:
    import glob

    (ckpt_dir,) = glob.glob(f"{tmp}/logs/ppo/*/{run_name}/version_*/checkpoint")
    return ckpt_dir


def serve_model(torch, np, ckpt_dir: str) -> dict:
    """A PPO run's newest committed checkpoint as ``cli_serve`` builds it on
    the card (the stored config resolved, ``build_served_policy``), with the plain
    forward: the training player's greedy actions (``PPOPlayer.get_actions``,
    what the test episode runs) on the same weights, as env indices, on the
    card (or on ``device``: the CPU a fleet's spill slot serves on)."""
    import os

    from sheeprl_tpu_torch.algos.ppo.agent import build_agent, real_actions_from_onehot
    from sheeprl_tpu_torch.algos.ppo.convert import agent_from_flax
    from sheeprl_tpu_torch.config.compose import load_config_file, resolve
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.envs.spaces import action_dims
    from sheeprl_tpu_torch.resilience.discovery import newest_committed
    from sheeprl_tpu_torch.serve.policy import build_served_policy
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from sheeprl_tpu_torch.utils.utils import dotdict

    ckpt = newest_committed(ckpt_dir)
    cfg = dotdict(resolve(load_config_file(os.path.join(os.path.dirname(ckpt_dir), "config.yaml"))))
    cfg.env.capture_video = False
    state = load_checkpoint(ckpt.path)
    policy = build_served_policy(cfg, state, "cuda")
    env = make_env(cfg, cfg.seed, 0, None, "serve")()
    dims, continuous = action_dims(env.action_space)
    space = env.observation_space
    env.close()

    def plain(agent_state, device="cuda"):
        _, player = build_agent(dims, continuous, cfg, space, agent_from_flax(agent_state), device=device)

        def actions(obs_list):
            batch = {k: np.stack([o[k] for o in obs_list]) for k in policy.obs_spec}
            onehot, _, _ = player.get_actions(batch, greedy=True)
            return real_actions_from_onehot(dims, continuous, onehot).cpu().numpy()

        return actions

    return {"cfg": cfg, "state": state, "ckpt": ckpt, "policy": policy, "plain": plain}


def serve_obs(np, policy, n: int, seed: int) -> list:
    """``n`` seeded observations of the policy's spec (the load generator's
    draws)."""
    from sheeprl_tpu_torch.serve.loadgen import random_obs

    make, rng = random_obs(policy.obs_spec), np.random.default_rng(seed)
    return [make(rng) for _ in range(n)]


def plain_at(np, plain, obs_list: list, batch: int):
    """``plain`` over ``obs_list`` in batches of ``batch`` rows (the last
    zero-padded, as a rung pads it)."""
    rows = []
    for j in range(0, len(obs_list), batch):
        chunk = obs_list[j : j + batch]
        pad = [{k: np.zeros_like(v) for k, v in chunk[0].items()}] * (batch - len(chunk))
        rows.append(plain(chunk + pad)[: len(chunk)])
    return np.concatenate(rows)


def serve_config(**node):
    from sheeprl_tpu_torch.serve.config import serve_config_from_cfg

    return serve_config_from_cfg({"serve": {"batch_ladder": list(SERVE_LADDER), "monitor_interval_s": 0.01, "backoff_base_s": 0.01, **node}})


def phase_serve_ladder(torch, np, model: str, served: dict) -> dict:
    """15(a) the ladder of one model: a ``ModelStore`` of two replica slots
    (one CUDA graph a rung a slot), each rung's replay held against the same
    rung run eagerly (bit for bit) and against the plain forward (the
    player's greedy actions, equal), ms a replay back to back (CUDA events),
    host ms a round trip (stage, copy in, replay, copy out, synchronize),
    capture seconds a rung; then host ms a request through
    ``ServeClient.infer`` at batch 1, with the gather window at 0 and at its
    default (slo_ms / 5, capped at 10 ms)."""
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.model import ModelStore
    from sheeprl_tpu_torch.serve.server import PolicyServer

    policy, ckpt = served["policy"], served["ckpt"]
    plain = served["plain"](served["state"]["agent"])
    store = ModelStore(policy, SERVE_LADDER, step=ckpt.step, path=ckpt.path, slots=2)
    row = {"capture_s": dict(store.warmup_s), "rungs": {}}
    for b in SERVE_LADDER:
        obs = serve_obs(np, policy, b, seed=b)
        got = {}
        for slot, ladder in enumerate(store.current.ladders):
            rung = ladder.rung(b)
            got[slot] = rung.run(obs)
            eager = rung.eager(obs)
            if not np.array_equal(got[slot], eager):
                raise AssertionError(f"15(a) {model} rung {b} slot {slot}: replay {got[slot]} != eager {eager}")
        want = plain(obs)
        if not (np.array_equal(got[0], got[1]) and np.array_equal(got[0].astype(want.dtype), want)):
            raise AssertionError(f"15(a) {model} rung {b}: replays {got} != plain {want}")
        rung = store.current.ladders[0].rung(b)
        with torch.cuda.stream(rung.stream):
            for _ in range(10):
                rung.step.replay()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(SERVE_REPLAYS):
                rung.step.replay()
            end.record()
        end.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_ROUND_TRIPS):
            rung.run(obs)
        row["rungs"][b] = {
            "bit_equal_to_eager": True,
            "equal_to_plain": True,
            "ms_per_replay": start.elapsed_time(end) / SERVE_REPLAYS,
            "host_ms_per_round_trip": (time.perf_counter() - t0) * 1e3 / SERVE_ROUND_TRIPS,
        }
    obs = serve_obs(np, policy, SERVE_REQUESTS, seed=0)
    want = plain(obs)
    for window in (0.0, None):
        server = PolicyServer(policy, serve_config(gather_window_ms=window), step=ckpt.step, path=ckpt.path).start()
        try:
            client = ServeClient(server, seed=0)
            client.infer(obs[0])
            t0 = time.perf_counter()
            out = np.stack([client.infer(o) for o in obs])
            ms = (time.perf_counter() - t0) * 1e3 / len(obs)
            snap = server.snapshot()
        finally:
            server.close()
        if not np.array_equal(out.astype(want.dtype), want) or snap["mean_batch"] != 1.0:
            raise AssertionError(f"15(a) {model} ServeClient at batch 1 (window {window}): {snap}")
        row[f"host_ms_per_request_b1_window_{'default' if window is None else 0}"] = ms
    row["host_ms_per_request_b1_p50_server"] = snap["p50_ms"]
    return row


def serve_cli(tmp: str, ckpt_dir: str, run: str, *extra) -> dict:
    """``cli.run(["serve", ...])`` in this process, its printing kept apart:
    the ``serve_stats`` JSON it prints and the ``RUNS.jsonl`` record it
    appends."""
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.obs.registry import read_run_records

    runs = f"{tmp}/serve_{run}_RUNS.jsonl"
    argv = ["serve", f"ckpt_dir={ckpt_dir}", "serve.load.enabled=true", f"serve.load.duration_s={SERVE_LOAD_S}", f"metric.telemetry.runs_jsonl={runs}", *extra]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.run(argv)
    text = buf.getvalue()
    snap = json.loads(text[text.index('{\n  "serve_stats"') :])["serve_stats"]
    record = read_run_records(runs)[-1]
    return {"snap": snap, "record": record, "banner": text.splitlines()[:2], "seconds": time.perf_counter() - t0}


def phase_serve_cli(torch, tmp: str, ckpt_dir: str) -> dict:
    """15(b) ``python -m sheeprl_tpu_torch serve ckpt_dir=<phase 12's exp=ppo
    run>/checkpoint serve.load.enabled=true`` through ``cli.run``: a closed
    loop at concurrency 8 for ``SERVE_LOAD_S``, then an open loop at
    ``SERVE_OPEN_RATE_HZ``: QPS, p50/p95 against ``slo_ms``, ``slo_met``,
    mean batch, shed and retry counts, the run record's ``kind``."""
    report = {"card": card_line()}
    for run, extra in (("closed_loop", ()), ("open_loop", (f"serve.load.rate_hz={SERVE_OPEN_RATE_HZ}",))):
        out = serve_cli(tmp, ckpt_dir, run, *extra)
        snap, load = out["snap"], out["snap"]["load_report"]
        row = {
            **{k: load[k] for k in ("mode", "concurrency", "target_rate_hz", "ok", "shed", "expired", "errors", "client_retries", "client_rejections", "qps", "p50_ms", "p95_ms", "slo_ms", "slo_met")},
            "mean_batch": snap["mean_batch"],
            "server_p50_ms": snap["p50_ms"],
            "server_p95_ms": snap["p95_ms"],
            "warmup_s": snap["warmup_s"],
            "record_kind": out["record"]["kind"],
            "record_outcome": out["record"]["outcome"],
            "banner": out["banner"],
            "process_seconds": out["seconds"],
        }
        report[run] = row
        print(f"phase 15(b) serve_cli_{run} " + json.dumps(row), flush=True)
        if row["record_kind"] != "serve" or row["record_outcome"] != "completed" or load["ok"] <= 0 or load["errors"]:
            raise AssertionError(f"15(b) serve CLI {run}: {row}")
    return report


def commit_perturbed(np, served: dict, step: int, scale: float = 0.5) -> tuple:
    """A second committed checkpoint of the same structure beside the served
    one: every weight moved by seeded noise (a newer training commit)."""
    import os

    from sheeprl_tpu_torch.resilience.manifest import build_manifest
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(step)

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        a = np.asarray(node)
        return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)

    state = {"agent": move(served["state"]["agent"]), "update": 0}
    path = os.path.join(os.path.dirname(served["ckpt"].path), f"ckpt_{step}_0.ckpt")
    save_checkpoint(path, state, manifest=build_manifest(step=step, backend="pickle", world_size=1, state=state))
    return path, state


def phase_serve_drills(torch, np, served: dict) -> dict:
    """15(c) the drills on the card over the exp=ppo MLP: (1)
    ``replica_crash`` at batch 5 of one replica: the requeued request is
    served by the restarted replica, every answer equal to the plain
    forward; (2) a hot swap under load (8 threads of distinct requests, two
    replicas) at the config's default SLO and deadline: nothing dropped,
    both versions served, every answer equal to the plain forward of the
    version stamped on it, at one of the ladder's batch sizes (rows are
    independent), with the longest request latency across the swap and the
    flip's pause; (3) ``poison_swap`` rejected, the old version serving."""
    import threading

    from sheeprl_tpu_torch.serve.errors import SwapRejected
    from sheeprl_tpu_torch.serve.server import PolicyServer

    policy, ckpt = served["policy"], served["ckpt"]
    plain_old = served["plain"](served["state"]["agent"])
    report = {}

    cfg = serve_config(num_replicas=1, slo_ms=500.0, fault_injection={"enabled": True, "faults": [{"kind": "replica_crash", "replica": 0, "at_batch": 5}]})
    server = PolicyServer(policy, cfg, step=ckpt.step, path=ckpt.path).start()
    try:
        obs = serve_obs(np, policy, SERVE_CRASH_REQUESTS, seed=1)
        out = np.stack([server.infer(o) for o in obs])
        deadline = time.monotonic() + 5.0
        while server.replicas.total_restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = server.snapshot()
    finally:
        server.close()
    want = np.concatenate([plain_old([o]) for o in obs])
    report["replica_crash"] = {"requests": len(obs), "completed": snap["completed"], "restarts": snap["restarts"], "events": snap["events"], "equal_to_plain": bool(np.array_equal(out.astype(want.dtype), want))}
    if not (report["replica_crash"]["equal_to_plain"] and snap["restarts"] == 1 and snap["completed"] == len(obs) and snap["events"].get("replica_restart") == 1):
        raise AssertionError(f"15(c) replica_crash drill: {report['replica_crash']}")

    new_step = ckpt.step + 1000
    new_path, new_state = commit_perturbed(np, served, new_step)
    plain_new = served["plain"](new_state["agent"])
    events = []
    cfg = serve_config()  # the default SLO, gather window and deadline
    server = PolicyServer(policy, cfg, step=ckpt.step, path=ckpt.path, on_event=lambda kind, info: events.append((kind, info))).start()
    stop = threading.Event()
    records, failures = [], []

    def traffic(seed: int) -> None:
        from sheeprl_tpu_torch.serve.loadgen import random_obs

        make, rng = random_obs(policy.obs_spec), np.random.default_rng(1000 + seed)
        while not stop.is_set():
            o = make(rng)
            try:
                t_in = time.perf_counter()
                req = server.submit(o)
                out = server.wait(req)
                records.append((o, out, req.served_step, t_in, time.perf_counter()))
            except Exception as err:  # the drill counts every failure
                failures.append(repr(err))

    threads = [threading.Thread(target=traffic, args=(i,), daemon=True) for i in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(SERVE_SWAP_TRAFFIC_S)
        t0 = time.perf_counter()
        server.request_swap(new_path)
        swap_s = time.perf_counter() - t0
        time.sleep(SERVE_SWAP_TRAFFIC_S)
        stop.set()
        for t in threads:
            t.join(10.0)
        snap = server.snapshot()
    finally:
        stop.set()
        server.close()
    if any(t.is_alive() for t in threads):
        raise AssertionError("15(c) hot swap: a traffic thread did not stop")
    steps = [r[2] for r in records]
    obs = [r[0] for r in records]
    got = np.stack([r[1] for r in records])
    latency_ms = np.array([(r[4] - r[3]) * 1e3 for r in records])
    # requests in flight at any instant of request_swap
    across = [(r[4] - r[3]) * 1e3 for r in records if r[3] < t0 + swap_s and r[4] > t0]
    matches = 0
    for fn, step in ((plain_old, ckpt.step), (plain_new, new_step)):
        idx = [i for i, s in enumerate(steps) if s == step]
        if idx:
            ok = np.zeros(len(idx), dtype=bool)
            for b in SERVE_LADDER:
                want = plain_at(np, fn, [obs[i] for i in idx], b)
                ok |= (got[idx].astype(want.dtype) == want).all(axis=-1)
            matches += int(ok.sum())
    differ = int((plain_at(np, plain_old, obs, 8) != plain_at(np, plain_new, obs, 8)).any(axis=-1).sum())
    report["hot_swap"] = {
        "requests": len(records),
        "failures": len(failures),
        "old_version_answers": steps.count(ckpt.step),
        "new_version_answers": steps.count(new_step),
        "equal_to_plain_of_stamped_version": matches,
        "answers_where_versions_differ": differ,
        "slo_ms": cfg.slo_ms,
        "deadline_ms": cfg.default_deadline_s * 1e3,
        "shed_expired": snap["shed_expired"],
        "shed_overloaded": snap["shed_overloaded"],
        "failed": snap["failed"],
        "latency_ms_p50": float(np.percentile(latency_ms, 50)),
        "latency_ms_p99": float(np.percentile(latency_ms, 99)),
        "latency_ms_max": float(latency_ms.max()),
        "requests_across_swap": len(across),
        "latency_ms_max_across_swap": max(across, default=None),
        "request_swap_s": swap_s,
        # the version's 8 graphs, captured while serving paused
        "swap_capture_s": [info["capture_s"] for kind, info in events if kind == "swap"],
        # the gate held alone: for each slot's captures, then for the flip;
        # pause_s the longest of them
        "swap_pause_s": [info["pause_s"] for kind, info in events if kind == "swap"],
        "swap_pauses_s": [info["pauses_s"] for kind, info in events if kind == "swap"],
        "serving_step": snap["serving_step"],
        "swaps": snap["swaps"],
    }
    if failures or snap["shed_expired"] or snap["failed"] or matches != len(records) or not (report["hot_swap"]["old_version_answers"] and report["hot_swap"]["new_version_answers"]) or snap["serving_step"] != new_step:
        raise AssertionError(f"15(c) hot swap under load: {report['hot_swap']} {failures[:3]}")

    cfg = serve_config(fault_injection={"enabled": True, "faults": [{"kind": "poison_swap", "at_swap": 1}]})
    server = PolicyServer(policy, cfg, step=ckpt.step, path=ckpt.path).start()
    try:
        try:
            server.request_swap(new_path)
            reason = None
        except SwapRejected as err:
            reason = str(err)
        snap = server.snapshot()
        out = server.infer(serve_obs(np, policy, 1, seed=2)[0])
    finally:
        server.close()
    report["poison_swap"] = {"rejected": reason, "serving_step": snap["serving_step"], "swap_rejects": snap["swap_rejects"], "answer": np.asarray(out).tolist()}
    if reason is None or "non-finite" not in reason or snap["serving_step"] != ckpt.step or snap["swap_rejects"] != 1:
        raise AssertionError(f"15(c) poison_swap drill: {report['poison_swap']}")
    return report


def phase_serve(torch, np, fg, tmp: str) -> dict:
    """Phase 15: (a) the ladder of both models, (b) the CLI's load runs,
    (c) the drills; serving launches neither B1 nor B2 (checked)."""
    b1_before, b2_before = fg.launch_count, fg.proj_launch_count
    report = {"card": card_line(), "ladder": {}}
    served = {model: serve_model(torch, np, serve_ckpt_dir(tmp, run)) for model, run in SERVE_RUNS.items()}
    for model in SERVE_RUNS:
        report["ladder"][model] = phase_serve_ladder(torch, np, model, served[model])
        print(f"phase 15(a) serve_ladder_{model} " + json.dumps(report["ladder"][model]), flush=True)
    report["cli"] = phase_serve_cli(torch, tmp, serve_ckpt_dir(tmp, SERVE_RUNS["mlp_cartpole"]))
    report["drills"] = phase_serve_drills(torch, np, served["mlp_cartpole"])
    print("phase 15(c) serve_drills " + json.dumps(report["drills"]), flush=True)
    if (fg.launch_count, fg.proj_launch_count) != (b1_before, b2_before):
        raise AssertionError(f"phase 15 launched B1 {fg.launch_count - b1_before} and B2 {fg.proj_launch_count - b2_before} times, want 0")
    print("phase 15 b1_b2_launches 0", flush=True)
    return report


# phase 16: Plan2Explore on Dreamer-V3 at S widths (configs/algo/dreamer_v3_S.yaml's keys on
# the command line over exp=p2e_dv3_exploration's XL defaults), bf16-mixed, PixelCatcher
P2E_S = {
    "algo.dense_units": 512,
    "algo.mlp_layers": 2,
    "algo.world_model.encoder.cnn_channels_multiplier": 32,
    "algo.world_model.recurrent_model.recurrent_state_size": 512,
    "algo.world_model.transition_model.hidden_size": 512,
    "algo.world_model.representation_model.hidden_size": 512,
}
# the CLI runs, cut from the exp's 5M (exploration) and 1M (finetuning)
# steps, 1024 and 16384 learning_starts and 1M-step buffers: training
# starts once each of the 4 envs holds one 64-step sequence, for 8 updates
P2E_CUTS = {"algo.total_steps": 288, "algo.learning_starts": 256, "buffer.size": 4096}
# an exploration step: the observation scan (T calls at B) and two
# imaginations of horizon + 1 calls at B = T * B
P2E_CALLS = SCAN_CALLS + 2 * IMAGINE_CALLS
# B1 against the plain model at bf16-mixed: tests/test_torch_precision.py's
# train-step bounds, TRAIN_TOL (metrics, relative to max(|plain|, 1)) and
# TRAIN_GRAD_TOL (each gradient tensor, relative to its largest element)
P2E_METRIC_BOUND = 2.0**-8
P2E_GRAD_BOUND = 16 * 2.0**-8


def p2e_cfg(exp: str = "p2e_dv3_exploration", fused: str = "auto", precision: str = BF16, argv=(), **overrides):
    """``exp`` at S widths on PixelCatcher, composed as the CLI composes it
    (``argv``, then the dotted ``overrides``)."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.utils import dotdict

    args = {**P2E_S, "seed": SEED, "algo.world_model.recurrent_model.fused": fused, "fabric.precision": precision, **overrides}
    return dotdict(compose("config", [f"exp={exp}", "env=pixel_catcher", *argv] + [f"{k}={v}" for k, v in args.items()]))


def p2e_models(torch, cfg, obs_space, actions_dim, is_continuous, state=None):
    """The P2E agent of ``cfg`` on the card (seeded, or ``state``'s models),
    its optimizers, Moments and train step."""
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as expl
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent
    from sheeprl_tpu_torch.algos.p2e_dv3.convert import load_checkpoint_state
    from sheeprl_tpu_torch.ops.math import init_moments

    agent = build_agent(actions_dim, is_continuous, cfg, obs_space, device="cuda")
    if state is not None:
        load_checkpoint_state(state, agent)
    opts = expl.build_optimizers(cfg, agent)
    dev = torch.device("cuda")
    moments = (init_moments(dev), {k: init_moments(dev) for k in agent.critics_exploration})
    return agent, opts, moments, expl.make_train_step(agent, opts, cfg, is_continuous)


def p2e_params(agent):
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import trained_modules

    return [p for m in trained_modules(agent) for p in m.parameters()]


def phase_p2e_step(torch, np, fg, rb, obs_space, actions_dim, is_continuous):
    """16(a) the exploration train step at S, bf16-mixed, on REPLAYED_STEPS
    batches of phase 6's PixelCatcher replay (B=16, T=64, horizon 15), the
    smooth samplers and cuDNN's deterministic algorithms: replays of the
    captured step (B1 inside) against as many eager steps (metrics, every
    trained parameter and Moments within REPLAY_BOUND); one eager B1 step
    against the plain model (fused: flax) from the same weights within
    P2E_METRIC_BOUND and P2E_GRAD_BOUND, B1 called P2E_CALLS times a step;
    then ms a replay (CUDA events) and a profiler window over replays: B1's
    gru_step kernels a replay, the device's idle share, the top kernels
    (the ensemble's batched products among them)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as expl
    from sheeprl_tpu_torch.algos.p2e_dv3.convert import checkpoint_state

    dev = torch.device("cuda")
    batches = [to_batch(rb.sample(TRAIN_B, sequence_length=TRAIN_T), ["rgb"], dev) for _ in range(REPLAYED_STEPS)]
    cfg = p2e_cfg()
    report = {"B": TRAIN_B, "T": TRAIN_T, "horizon": HORIZON, "precision": BF16, "replay_bound": REPLAY_BOUND}
    with cudnn_deterministic(torch), deterministic():
        graphed, gopts, (gmt, gme), gstep = p2e_models(torch, cfg, obs_space, actions_dim, is_continuous)
        if not graphed.world_model.fused or graphed.world_model.dtype != torch.bfloat16:
            raise AssertionError("the bf16-mixed S P2E world model is not the bf16 B1 model")
        state = checkpoint_state(graphed, gopts, gmt, gme)
        eager, _, (emt, eme), estep = p2e_models(torch, cfg, obs_space, actions_dim, is_continuous, state)
        plain, _, (pmt, pme), pstep = p2e_models(torch, p2e_cfg(fused="flax"), obs_space, actions_dim, is_continuous, state)
        # one eager step of B1 and of the plain model from the same weights
        grads = {}
        out = {}
        for key, step, mt, me, want in (("b1", estep, emt, eme, P2E_CALLS), ("plain", pstep, pmt, pme, 0)):
            g = grads[key] = {}
            fg.reset_launch_count()
            out[key] = step(mt, me, batches[0], None, g)
            torch.cuda.synchronize()
            if (fg.launch_count, fg.bf16_x_launch_count) != (want, want) or not torch.isfinite(out[key]).all():
                raise AssertionError(f"P2E eager step ({key}): {fg.launch_count} B1 calls, {fg.bf16_x_launch_count} with a bf16 x, want {want}")
        order = expl.metric_order(tuple(graphed.critics_exploration))
        metric_err = ((out["b1"] - out["plain"]).abs() / out["plain"].abs().clamp_min(1.0)).max().item()
        grad_err = {
            k: max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(grads["b1"][k], grads["plain"][k]))
            for k in grads["b1"]
        }
        report["b1_vs_plain"] = {
            "metric_max_rel_err": metric_err,
            "grad_max_rel_err": grad_err,
            "metric_bound": P2E_METRIC_BOUND,
            "grad_bound": P2E_GRAD_BOUND,
            "fused_gru_bf16_x_calls_per_step": P2E_CALLS,
            "metrics_b1": dict(zip(order, out["b1"].tolist())),
        }
        if metric_err > P2E_METRIC_BOUND or max(grad_err.values()) > P2E_GRAD_BOUND:
            raise AssertionError(f"the P2E B1 step against the plain model: {report['b1_vs_plain']}")
        del plain, pstep, grads
        # replays against eager steps: the eager agent restarts from the weights
        eager, _, (emt, eme), estep = p2e_models(torch, cfg, obs_space, actions_dim, is_continuous, state)
        inputs = {k: v.clone() for k, v in batches[0].items()}
        fn = expl.make_train_fn(gstep, graphed, gopts, gmt, gme, inputs, None)
        metric_errs = []
        for b in batches:
            for k, v in b.items():
                fn.inputs[k].copy_(v)
            got = fn()
            want = estep(emt, eme, b, None)
            metric_errs.append(rel_err(torch, got, want))
        torch.cuda.synchronize()
        param_err = max(
            ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(p2e_params(graphed), p2e_params(eager))
        )
        moments_err = max(
            rel_err(torch, getattr(a, f), getattr(b, f))
            for a, b in [(gmt, emt)] + [(gme[k], eme[k]) for k in gme]
            for f in ("low", "high")
        )
        report["replayed_vs_eager"] = {
            "metric_max_rel_err_per_step": metric_errs,
            "param_max_rel_err": param_err,
            "moments_max_rel_err": moments_err,
            "captured_fused_gru_calls": fn.captured_launches,
            "replays": fn.replays,
        }
        if max(metric_errs + [param_err, moments_err]) > REPLAY_BOUND or fn.captured_launches != P2E_CALLS:
            raise AssertionError(f"the P2E step replayed against eager: {report['replayed_vs_eager']}")
        del graphed, eager, estep, fn
    torch.cuda.empty_cache()
    # timing with the real samplers and a train generator, as main() runs it
    agent, opts, (mt, me), step = p2e_models(torch, cfg, obs_space, actions_dim, is_continuous)
    fn = expl.make_train_fn(step, agent, opts, mt, me, {k: v.clone() for k, v in batches[0].items()}, torch.Generator(device="cuda").manual_seed(SEED))
    fn()  # capture and one replay
    report["ms_per_replay"] = [step_ms(torch, fn), step_ms(torch, fn)]
    report["profile"] = profile_replays(torch, fn, replays=2, top=12)
    report["card"] = card_line()
    print("phase 16(a) p2e_step " + json.dumps(report), flush=True)
    if report["profile"]["gru_step_kernels_per_replay"] != 2 * P2E_CALLS:
        raise AssertionError(f"a replayed P2E step ran {report['profile']['gru_step_kernels_per_replay']} gru_step kernels, want {2 * P2E_CALLS}")
    del agent, fn
    return report


def phase_p2e_cli(torch, np, fg, tmp: str):
    """16(b) ``exp=p2e_dv3_exploration`` through ``cli.run`` at S widths
    with P2E_CUTS, ending with its checkpoint; ``exp=p2e_dv3_finetuning``
    from it, cut alike; ``cli_eval`` on the finetuning checkpoint. Reports
    env-steps/s of each run, B1's launches (the wrapper's calls outside
    capture plus the captured calls times the replays), the policy step at
    which the finetuning player switched from the exploration actor to the
    task actor, and the cuts."""
    import glob
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_exploration as expl
    from sheeprl_tpu_torch.algos.p2e_dv3 import p2e_dv3_finetuning as fine

    common = {**P2E_S, **P2E_CUTS, "seed": SEED, "log_base_dir": f"{tmp}/logs", "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl"}
    args = [f"{k}={v}" for k, v in common.items()]
    report = {"card": card_line(), "cuts": P2E_CUTS, "widths": P2E_S}
    runs = {}
    ckpt = None
    for name, module, extra in (
        ("exploration", expl, ["exp=p2e_dv3_exploration", "env=pixel_catcher", "run_name=explore"]),
        ("finetuning", fine, ["exp=p2e_dv3_finetuning", "env=pixel_catcher", "run_name=finetune"]),
    ):
        if ckpt is not None:
            extra = extra + [f"checkpoint.exploration_ckpt_path={ckpt}"]
        out, calls, bf16_calls, seconds = cli_in_process(torch, fg, extra + args, module)
        # the wrapper's calls outside capture, and the captured ones once a replay
        captured = out["captured_launches_per_step"]
        launches = calls - captured + captured * out["replays"]
        bf16_launches = bf16_calls - captured + captured * out["replays"]
        ckpts = sorted(glob.glob(f"{out['log_dir']}/checkpoint/*.ckpt"))
        runs[name] = {
            "env_steps": out["env_steps"],
            "gradient_steps": out["gradient_steps"],
            "run_seconds": seconds,
            "loop_seconds": out["seconds"],
            "env_steps_per_s": out["env_steps"] / out["seconds"],
            "replay_buffer": out["replay_buffer"],
            "fused_gru_wrapper_calls": calls,
            "fused_gru_bf16_x_wrapper_calls": bf16_calls,
            "fused_gru_captured_per_step": captured,
            "replays": out["replays"],
            "fused_gru_launches": launches,
            "fused_gru_bf16_x_launches": bf16_launches,
            "test_steps": out["test_steps"],
            "checkpoint": ckpts[-1].rsplit("/", 1)[-1] if ckpts else None,
            "last_metrics_finite": bool(out["metrics"]) and all(math.isfinite(v) for v in out["metrics"].values()),
        }
        if name == "finetuning":
            runs[name]["player_switched_to_task_actor_at_policy_step"] = out["switched_at"]
        want_calls = P2E_CALLS if name == "exploration" else SCAN_CALLS + IMAGINE_CALLS
        if (
            out["env_steps"] != P2E_CUTS["algo.total_steps"]
            or out["gradient_steps"] <= 0
            or out["replays"] != out["gradient_steps"]
            or captured != want_calls
            # every call at bf16-mixed reads a bf16 x, the captured ones too
            or bf16_calls != calls
            or not runs[name]["last_metrics_finite"]
            or not ckpts
        ):
            raise AssertionError(f"P2E {name} through the CLI: {runs[name]}")
        ckpt = ckpts[-1]
    # the first gradient step follows the env step at learning_starts; the
    # task actor takes the next one
    switched = runs["finetuning"]["player_switched_to_task_actor_at_policy_step"]
    num_envs = int(p2e_cfg().env.num_envs)
    if switched != P2E_CUTS["algo.learning_starts"] + num_envs:
        raise AssertionError(f"the finetuning player switched to the task actor at policy step {switched}")
    # cli_eval on the finetuning checkpoint (the task actor), one capped episode
    buf = io.StringIO()
    fg.reset_launch_count()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.evaluation([f"checkpoint_path={ckpt}", f"env.max_episode_steps={EVAL_CAP}"])
    torch.cuda.synchronize()
    evaluated = "Test - Reward:" in buf.getvalue()
    report["cli_eval"] = {
        "seconds": time.perf_counter() - t0,
        "fused_gru_launches": fg.launch_count,
        "fused_gru_bf16_x_launches": fg.bf16_x_launch_count,
        "episode_played": evaluated,
    }
    records = [json.loads(line) for line in open(f"{tmp}/RUNS.jsonl")]
    report["records"] = [[r["kind"], r["algo"], r["outcome"]] for r in records]
    report["runs"] = runs
    print("phase 16(b) p2e_cli " + json.dumps(report), flush=True)
    if not evaluated or fg.launch_count <= 0 or fg.bf16_x_launch_count != fg.launch_count or report["records"] != [
        ["train", "p2e_dv3_exploration", "completed"],
        ["train", "p2e_dv3_finetuning", "completed"],
        ["eval", "p2e_dv3_finetuning", "completed"],
    ]:
        raise AssertionError(f"P2E cli_eval or run records: {report['cli_eval']}, {report['records']}")
    launches = {name: r["fused_gru_launches"] for name, r in runs.items()}
    launches["cli_eval"] = report["cli_eval"]["fused_gru_launches"]
    bf16_launches = {name: r["fused_gru_bf16_x_launches"] for name, r in runs.items()}
    bf16_launches["cli_eval"] = report["cli_eval"]["fused_gru_bf16_x_launches"]
    return launches, bf16_launches, report



# --------------------------------------------------------------------------- #
# phase 17: placement, PPO's overlapped collection, Dreamer-V2
# --------------------------------------------------------------------------- #

# 17(a): exp=ppo (CartPole-v1, the 64 x 2 MLP, 4 sync envs) for
# PLACE_PPO_UPDATES updates (from 128) at each placement; Dreamer-V3 S on
# PixelCatcher with the player on the host, cut to the two train windows
# after learning_starts (from 5M env steps, 1024 and a 1M buffer), its
# episodes (the test's too, which the host player plays) to EVAL_CAP steps
PLACE_PPO_UPDATES = 2  # 3 until phase 18 needed the time
PLACE_DV3_CUTS = {"algo.total_steps": 260, "algo.learning_starts": 256, "buffer.size": 4096, "algo.run_test": True, "env.max_episode_steps": EVAL_CAP}
# 17(b): the same exp=ppo host loop, overlap off and on, for
# OVERLAP_UPDATES updates each (from 128)
OVERLAP_UPDATES = 6
# 17(c): Dreamer-V2 at exp=dreamer_v2's widths on PixelCatcher (its
# env=gym pixels need pygame, ROADMAP A1): the step on phase 6's replay
# (B=16, T=50, horizon 15), and the CLI runs cut from 5M env steps, 1000
# learning_starts and a 5M buffer; the episode buffer's windows are 24
# long (from 50): a PixelCatcher episode ends at its first miss, 31 steps
# or more, and the buffer refuses episodes shorter than a window
DV2_T = 50
DV2_CUTS = {"algo.total_steps": 288, "algo.learning_starts": 256, "buffer.size": 4096, "algo.run_test": True}
DV2_EPISODE_T = 24


def ppo_cli_recording(torch, tmp: str, run_name: str, overrides: list, record=None) -> tuple:
    """``cli.run`` of ``exp=ppo`` with ``overrides``, PPO's ``main`` kept
    for its report and given ``record``; returns (report, seconds)."""
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.ppo import ppo

    out = {}
    real_main = ppo.main
    argv = [*overrides, f"seed={SEED}", "env.capture_video=False", f"log_base_dir={tmp}/logs", f"metric.telemetry.runs_jsonl={tmp}/RUNS.jsonl", f"run_name={run_name}"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(ppo, "main", lambda fabric, cfg: out.update(real_main(fabric, cfg, record=record))), contextlib.redirect_stdout(buf):
        cli.run(argv)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_placement(torch, np, fg, tmp: str) -> tuple:
    """17(a) the round trip of one tiny op on the card and what ``auto``
    resolves to for the player and for training (the card); ``exp=ppo``
    with ``algo.player_device=cpu``, then ``algo.train_device=cpu``;
    Dreamer-V3 S with ``algo.player_device=cpu``: env-steps/s, the
    player's device, B1's launches in training (all in the learner: the
    host player's calls launch none) and, after the flush before the test,
    the player's copy equal to the learner's bit for bit. Returns B1's
    launches and the report."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import agent as dv3_agent
    from sheeprl_tpu_torch.parallel import fabric as pf

    cuda = torch.device("cuda")
    report = {"card": card_line()}
    rtt = pf.dispatch_roundtrip_seconds(cuda)
    mlp = [torch.zeros(4 * 64 + 64 * 64 + 64 * 2 + 64 * 64 + 64)]
    report["probe"] = {
        "dispatch_roundtrip_seconds": rtt,
        "threshold_seconds": pf._RTT_PROBE_THRESHOLD_S,
        "player_auto": str(pf.resolve_player_device("auto", cuda) or cuda),
        "train_auto_ppo_mlp": str(pf.resolve_train_device("auto", mlp, 1, cuda) or cuda),
    }
    print("phase 17(a) placement_probe " + json.dumps(report["probe"]), flush=True)
    if report["probe"]["player_auto"] != "cuda" or report["probe"]["train_auto_ppo_mlp"] != "cuda":
        raise AssertionError(f"auto placed the player or the update off a local card: {report['probe']}")
    base = ["exp=ppo", "env.backend=sync", "metric.log_level=1", f"algo.total_steps={128 * 4 * PLACE_PPO_UPDATES}"]
    report["ppo"] = {}
    for name, key, want in (("player_cpu", "algo.player_device=cpu", ("cpu", "cuda")), ("train_cpu", "algo.train_device=cpu", ("cuda", "cpu"))):
        out, seconds = ppo_cli_recording(torch, tmp, f"ppo_{name}", [*base, key])
        row = {**ppo_run_report(out, seconds), "player_device": out["player_device"], "train_device": out["train_device"]}
        report["ppo"][name] = row
        print(f"phase 17(a) ppo_{name} " + json.dumps(row), flush=True)
        if (out["player_device"].split(":")[0], out["train_device"].split(":")[0]) != want or out["updates"] != PLACE_PPO_UPDATES:
            raise AssertionError(f"17(a) exp=ppo {key}: {row}")
    # Dreamer-V3 S: each player call counted with B1's launches inside it
    calls = {"player_calls": 0, "player_b1_launches": 0, "params_match_after_flush": None}
    real_get, real_flush = dv3_agent.PlayerDV3.get_actions, dv3_agent.PlayerDV3.flush_params

    def get_actions(self, *a, **kw):
        before = fg.launch_count
        out = real_get(self, *a, **kw)
        calls["player_calls"] += 1
        calls["player_b1_launches"] += fg.launch_count - before
        return out

    def flush_params(self):
        real_flush(self)
        calls["params_match_after_flush"] = self.params_match()
        calls["player_device"] = str(self.device)

    argv = cli_argv(tmp, "dv3_player_cpu", telemetry=False, **{**PLACE_DV3_CUTS, "algo.player_device": "cpu"})
    with mock.patch.object(dv3_agent.PlayerDV3, "get_actions", get_actions), mock.patch.object(dv3_agent.PlayerDV3, "flush_params", flush_params):
        out, wrapper_calls, bf16_calls, seconds = cli_in_process(torch, fg, argv)
    captured = out["captured_launches_per_step"]
    launches = wrapper_calls - captured + captured * out["replays"]
    bf16_launches = bf16_calls - captured + captured * out["replays"]
    row = {
        "env_steps": out["env_steps"],
        "gradient_steps": out["gradient_steps"],
        "train_windows": len(out["train_window_seconds"]),
        "env_steps_per_s": out["env_steps"] / out["seconds"],
        "run_seconds": seconds,
        "player_device": out["player_device"],
        "fused_gru_wrapper_calls": wrapper_calls,
        "fused_gru_captured_per_step": captured,
        "replays": out["replays"],
        "fused_gru_launches": launches,
        "fused_gru_bf16_x_launches": bf16_launches,
        **calls,
    }
    report["dreamer_v3_player_cpu"] = row
    print("phase 17(a) dv3_player_cpu " + json.dumps(row), flush=True)
    if (
        row["player_device"] != "cpu"
        or row["train_windows"] != 2
        or row["player_calls"] <= 0
        or row["player_b1_launches"] != 0
        or launches <= 0
        or captured != SCAN_CALLS + IMAGINE_CALLS
        or row["params_match_after_flush"] is not True
        or bf16_calls != wrapper_calls
    ):
        raise AssertionError(f"17(a) Dreamer-V3 with the player on the host: {row}")
    return launches, report


def phase_overlap(torch, np) -> dict:
    """17(b) ``exp=ppo``'s host loop at bf16-mixed with
    ``algo.overlap_collection`` off and on, the same seed and
    OVERLAP_UPDATES updates: env-steps/s, the share of the run spent in
    ``Time/train_wait_time``, which params collected each rollout (with
    overlap, rollout N those after update N-2), and each overlapped update
    replayed alone from its recorded inputs, state and train stream
    through a CUDA graph of its own on the default stream: bit for bit the
    same metrics, params and optimizer state."""
    from sheeprl_tpu_torch.algos.ppo import ppo
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.envs.spaces import Box, Dict as SpaceDict
    from sheeprl_tpu_torch.ops.graph import CapturedStep
    from sheeprl_tpu_torch.ops.optim import build_optimizer

    report = {"card": card_line()}
    base = ["exp=ppo", "env.backend=sync", "metric.log_level=1", f"algo.total_steps={128 * 4 * OVERLAP_UPDATES}"]
    record = []
    with tempfile.TemporaryDirectory() as tmp:
        for overlap in (False, True):
            out, seconds = ppo_cli_recording(torch, tmp, f"overlap_{overlap}", [*base, f"algo.overlap_collection={overlap}"], record if overlap else None)
            lag = 2 if overlap else 1
            row = {
                **ppo_run_report(out, seconds),
                "overlap_collection": out["overlap_collection"],
                "train_wait_seconds": out["train_wait_seconds"],
                "train_wait_share": out["train_wait_seconds"] / out["seconds"],
                "collected_with": out["collected_with"],
            }
            report["overlap" if overlap else "no_overlap"] = row
            print(f"phase 17(b) ppo_overlap_{overlap} " + json.dumps(row), flush=True)
            want = [[n, max(0, n - lag)] for n in range(1, OVERLAP_UPDATES + 1)]
            if out["overlap_collection"] is not overlap or [list(c) for c in out["collected_with"]] != want or out["updates"] != OVERLAP_UPDATES:
                raise AssertionError(f"17(b) overlap_collection={overlap}: {row}")
    cfg = ppo_cfg(*base)
    space = SpaceDict({"state": Box(-np.inf, np.inf, (4,), np.float32)})
    agent, _ = build_agent((2,), False, cfg, space, device="cuda")
    opt = build_optimizer(list(agent.parameters()), cfg.algo.optimizer, float(cfg.algo.max_grad_norm))
    gen = torch.Generator(device="cuda")
    n_local = int(cfg.algo.rollout_steps) * int(cfg.env.num_envs)
    update = ppo.make_update_fn(agent, ppo.make_local_train(agent, opt, cfg, ["state"], n_local, gen), cfg, ["state"])
    tensors = ppo.opt_state_tensors(agent, opt)
    fn = CapturedStep(update, {k: v.clone() for k, v in record[0]["inputs"].items()}, tensors, gen)
    equal = []
    for r in record:
        with torch.no_grad():
            for t, s in zip(tensors, r["state_before"]):
                t.copy_(s)
            for k, v in r["inputs"].items():
                fn.inputs[k].copy_(v)
        gen.set_state(r["generator"])
        got = fn()
        torch.cuda.synchronize()
        equal.append(bool(torch.equal(got, r["metrics"])) and all(torch.equal(t, s) for t, s in zip(tensors, r["state_after"])))
    report["updates_bit_equal_alone"] = equal
    print("phase 17(b) overlapped_updates_replayed_alone_bit_equal " + json.dumps(equal), flush=True)
    if len(equal) != OVERLAP_UPDATES or not all(equal):
        raise AssertionError(f"17(b) an overlapped update differs from the same update run alone: {equal}")
    return report


def dv2_cfg(*argv, **overrides):
    """``exp=dreamer_v2`` at its widths on PixelCatcher, bf16-mixed."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.utils import dotdict

    args = {"seed": SEED, "fabric.precision": BF16, **overrides}
    return dotdict(compose("config", ["exp=dreamer_v2", "env=pixel_catcher", "env.id=pixel_catcher", *argv] + [f"{k}={v}" for k, v in args.items()]))


@contextlib.contextmanager
def dv2_deterministic():
    """The smooth samplers where Dreamer-V2's modules look them up."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v2 import agent, dreamer_v2

    def actions(actor, state, generator=None, greedy=False):
        dists = agent.actor_dists(actor, actor(state))
        if actor.is_continuous:
            return dists[0].mean
        return torch.cat([d.mode + d.probs - d.probs.detach() for d in dists], -1)

    with mock.patch.object(agent, "compute_stochastic_state", smooth_state), mock.patch.object(dreamer_v2, "sample_actor_actions", actions):
        yield


def dv2_models(torch, cfg, obs_space, actions_dim, is_continuous, state=None):
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v2.convert import load_checkpoint_state
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers

    wm, actor, critic, target, _ = build_agent(actions_dim, is_continuous, cfg, obs_space, device="cuda")
    opts = build_optimizers(cfg, wm, actor, critic)
    if state is not None:
        load_checkpoint_state(state, wm, actor, critic, target, opts)
    return (wm, actor, critic, target), opts, dv2.make_train_step(wm, actor, critic, target, *opts, cfg)


def phase_dv2_step(torch, np, fg, rb, obs_space, actions_dim, is_continuous) -> dict:
    """17(c) one Dreamer-V2 gradient step at exp=dreamer_v2's widths
    (dense 400, 4 layers, ELU, CNN 48, recurrent 600, 32 x 32, horizon 15),
    bf16-mixed, on REPLAYED_STEPS batches of phase 6's PixelCatcher replay
    (B=16, T=50): replays of its CUDA graph against as many eager steps
    from the same weights, smooth samplers and cuDNN's deterministic
    algorithms (metrics and every parameter within REPLAY_BOUND); ms a
    replay, a profiler window (idle share, top kernels) and B1 launched by
    none of it (Dreamer-V2's recurrent model is the plain GRU cell)."""
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.dreamer_v2.convert import checkpoint_state
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch

    dev = torch.device("cuda")
    batches = [to_batch(rb.sample(TRAIN_B, sequence_length=DV2_T), ["rgb"], dev) for _ in range(REPLAYED_STEPS)]
    cfg = dv2_cfg()
    report = {"B": TRAIN_B, "T": DV2_T, "horizon": int(cfg.algo.horizon), "precision": BF16, "replay_bound": REPLAY_BOUND}
    fg.reset_launch_count()
    with cudnn_deterministic(torch), dv2_deterministic():
        graphed, gopts, gstep = dv2_models(torch, cfg, obs_space, actions_dim, is_continuous)
        state = checkpoint_state(*graphed, gopts)
        eager, _, estep = dv2_models(torch, cfg, obs_space, actions_dim, is_continuous, state)
        fn = dv2.make_train_fn(gstep, *graphed[:3], gopts, {k: v.clone() for k, v in batches[0].items()}, None)
        metric_errs = []
        for b in batches:
            for k, v in b.items():
                fn.inputs[k].copy_(v)
            dv2.hard_copy_(graphed[2], graphed[3])
            dv2.hard_copy_(eager[2], eager[3])
            got = fn()
            want = estep(b, None)
            metric_errs.append(rel_err(torch, got, want))
        torch.cuda.synchronize()
        params = lambda models: [p for m in models[:3] for p in m.parameters()]  # noqa: E731
        param_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(params(graphed), params(eager)))
        report["replayed_vs_eager"] = {
            "metric_max_rel_err_per_step": metric_errs,
            "param_max_rel_err": param_err,
            "metrics": dict(zip(dv2.METRIC_ORDER, got.tolist())),
            "replays": fn.replays,
        }
        if max(metric_errs + [param_err]) > REPLAY_BOUND or not torch.isfinite(got).all():
            raise AssertionError(f"17(c) the Dreamer-V2 step replayed against eager: {report['replayed_vs_eager']}")
        del graphed, eager, estep, fn
    torch.cuda.empty_cache()
    models, opts, step = dv2_models(torch, cfg, obs_space, actions_dim, is_continuous)
    fn = dv2.make_train_fn(step, *models[:3], opts, {k: v.clone() for k, v in batches[0].items()}, torch.Generator(device="cuda").manual_seed(SEED))
    fn()
    report["ms_per_replay"] = [step_ms(torch, fn), step_ms(torch, fn)]
    report["profile"] = profile_replays(torch, fn, replays=2, top=12)
    report["fused_gru_launches"] = fg.launch_count
    report["card"] = card_line()
    print("phase 17(c) dv2_step " + json.dumps(report), flush=True)
    if fg.launch_count != 0 or report["profile"]["gru_step_kernels_per_replay"] != 0:
        raise AssertionError(f"17(c) the Dreamer-V2 step launched B1: {fg.launch_count} calls")
    del models, fn
    torch.cuda.empty_cache()
    return report


def phase_dv2_cli(torch, np, fg, tmp: str) -> dict:
    """17(c) ``exp=dreamer_v2 env=pixel_catcher`` through ``cli.run`` cut
    to DV2_CUTS, once with ``buffer.type=sequential`` (the ring
    ``buffer.device`` picks) and once with ``buffer.type=episode
    buffer.prioritize_ends=True`` (windows of DV2_EPISODE_T), each with
    its test episode, then ``cli_eval`` on the episode run's checkpoint:
    env-steps/s, gradient steps, the replay and no B1 launch."""
    import glob
    import io

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2

    common = {**DV2_CUTS, "seed": SEED, "log_base_dir": f"{tmp}/logs", "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl"}
    report = {"card": card_line(), "cuts": {**DV2_CUTS, "episode_buffer.algo.per_rank_sequence_length": DV2_EPISODE_T}, "runs": {}}
    ckpt = None
    for name, extra in (
        ("sequential", ["buffer.type=sequential"]),
        ("episode", ["buffer.type=episode", "buffer.prioritize_ends=True", f"algo.per_rank_sequence_length={DV2_EPISODE_T}"]),
    ):
        argv = ["exp=dreamer_v2", "env=pixel_catcher", "env.id=pixel_catcher", f"run_name=dv2_{name}", *extra] + [f"{k}={v}" for k, v in common.items()]
        out, calls, _, seconds = cli_in_process(torch, fg, argv, dv2)
        ckpts = sorted(glob.glob(f"{out['log_dir']}/checkpoint/*.ckpt"))
        row = {
            "env_steps": out["env_steps"],
            "gradient_steps": out["gradient_steps"],
            "replays": out["replays"],
            "env_steps_per_s": out["env_steps"] / out["seconds"],
            "run_seconds": seconds,
            "train_seconds": out["train_seconds"],
            "replay_buffer": out["replay_buffer"],
            "episodes": out["episodes"],
            "player_device": out["player_device"],
            "fused_gru_calls": calls,
            "test_steps": out["test_steps"],
            "last_metrics_finite": bool(out["metrics"]) and all(math.isfinite(v) for v in out["metrics"].values()),
        }
        report["runs"][name] = row
        print(f"phase 17(c) dv2_cli_{name} " + json.dumps(row), flush=True)
        if out["env_steps"] != DV2_CUTS["algo.total_steps"] or out["gradient_steps"] <= 0 or out["replays"] != out["gradient_steps"] or calls != 0 or not row["last_metrics_finite"] or not ckpts or out["test_steps"] <= 0:
            raise AssertionError(f"17(c) exp=dreamer_v2 buffer.type={name}: {row}")
        ckpt = ckpts[-1]
    buf = io.StringIO()
    fg.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        cli.evaluation([f"checkpoint_path={ckpt}", f"env.max_episode_steps={EVAL_CAP}"])
    torch.cuda.synchronize()
    report["cli_eval"] = {"episode_played": "Test - Reward:" in buf.getvalue(), "fused_gru_launches": fg.launch_count}
    records = [json.loads(line) for line in open(f"{tmp}/RUNS.jsonl")]
    report["records"] = [[r["kind"], r["algo"], r["outcome"]] for r in records]
    print("phase 17(c) dv2_cli " + json.dumps({k: report[k] for k in ("cli_eval", "records", "cuts")}), flush=True)
    if not report["cli_eval"]["episode_played"] or fg.launch_count != 0 or report["records"] != [["train", "dreamer_v2", "completed"]] * 2 + [["eval", "dreamer_v2", "completed"]]:
        raise AssertionError(f"17(c) Dreamer-V2 cli_eval or run records: {report['cli_eval']}, {report['records']}")
    return report


# --------------------------------------------------------------------------- #
# phase 18: Dreamer-V1, then Plan2Explore over Dreamer-V2 and Dreamer-V1
# --------------------------------------------------------------------------- #

# 18(a), (b): each exp's own widths, bf16-mixed, on batches of phase 6's
# PixelCatcher replay (B, T): exp=dreamer_v1 and exp=p2e_dv1_exploration
# 50 x 50, exp=p2e_dv2_exploration 16 x 50, both explorations with their 10
# ensemble members
FAMILY_STEPS = {"dreamer_v1": (50, 50), "p2e_dv2_exploration": (16, 50), "p2e_dv1_exploration": (50, 50)}
# 18(c): each entry point through the CLI, cut as 17(c) cuts Dreamer-V2
# (from 5M or 1M env steps, learning_starts 5000, 1000 or 16384, and a 5M
# buffer); each finetuning run starts from its exploration run's checkpoint
FAMILY_CUTS = {"algo.total_steps": 288, "algo.learning_starts": 256, "buffer.size": 4096, "algo.run_test": True}
FAMILY_RUNS = ("dreamer_v1", "p2e_dv2_exploration", "p2e_dv2_finetuning", "p2e_dv1_exploration", "p2e_dv1_finetuning")


def family_cfg(exp: str, *argv, **overrides):
    """``exp`` at its widths on PixelCatcher, bf16-mixed."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils.utils import dotdict

    args = {"seed": SEED, "fabric.precision": BF16, **overrides}
    return dotdict(compose("config", [f"exp={exp}", "env=pixel_catcher", "env.id=pixel_catcher", *argv] + [f"{k}={v}" for k, v in args.items()]))


@contextlib.contextmanager
def family_deterministic():
    """The smooth samplers where the Dreamer-V1 and V2 modules look them up:
    Dreamer-V2's (``dv2_deterministic``), a fixed pattern for Dreamer-V1's
    Gaussian draw, and the actor's smooth action in Dreamer-V1's
    imagination."""
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v1 import agent as dv1_agent
    from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1
    from sheeprl_tpu_torch.algos.dreamer_v2 import agent as dv2_agent

    def noise(like, generator=None):
        idx = torch.arange(like.numel(), device=like.device, dtype=torch.float32)
        return (0.5 * torch.sin(0.7 * idx + 0.3)).reshape(like.shape).to(like.dtype)

    def actions(actor, state, generator=None, greedy=False):
        dists = dv2_agent.actor_dists(actor, actor(state))
        if actor.is_continuous:
            return dists[0].mean
        return torch.cat([d.mode + d.probs - d.probs.detach() for d in dists], -1)

    with dv2_deterministic(), mock.patch.object(dv1_agent, "gaussian_noise", noise), mock.patch.object(dreamer_v1, "sample_actor_actions", actions):
        yield


def family_models(torch, exp: str, cfg, obs_space, actions_dim, is_continuous, state=None):
    """``exp``'s models on the card, a seeded init or ``state`` (a
    checkpoint state): the trained modules, ``state()`` their checkpoint
    state, the eager ``step``, ``make_fn(inputs, generator)`` its captured
    step and ``refresh()`` of the target critics (a no-op without)."""
    import types

    from sheeprl_tpu_torch.algos.dreamer_v1 import convert as dv1_convert
    from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as dv1_build
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers
    from sheeprl_tpu_torch.algos.p2e_dv1 import agent as p2e_dv1_agent
    from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration
    from sheeprl_tpu_torch.algos.p2e_dv2 import agent as p2e_dv2_agent
    from sheeprl_tpu_torch.algos.p2e_dv2 import convert as p2e_convert
    from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration

    if exp == "dreamer_v1":
        wm, actor, critic, _ = dv1_build(actions_dim, is_continuous, cfg, obs_space, device="cuda")
        opts = build_optimizers(cfg, wm, actor, critic)
        if state is not None:
            dv1_convert.load_checkpoint_state(state, wm, actor, critic, opts)
        step = dv1.make_train_step(wm, actor, critic, *opts, cfg)
        return types.SimpleNamespace(
            modules=[wm, actor, critic],
            state=lambda: dv1_convert.checkpoint_state(wm, actor, critic, opts),
            step=step,
            make_fn=lambda inputs, gen: dv2.make_train_fn(step, wm, actor, critic, opts, inputs, gen),
            refresh=lambda: None,
            order=dv1.METRIC_ORDER,
        )
    family = {"p2e_dv2_exploration": (p2e_dv2_agent, p2e_dv2_exploration), "p2e_dv1_exploration": (p2e_dv1_agent, p2e_dv1_exploration)}
    agent_mod, expl = family[exp]
    agent = agent_mod.build_agent(actions_dim, is_continuous, cfg, obs_space, device="cuda")
    models = p2e_dv2_agent.models_of(agent)
    opts = p2e_dv2_exploration.build_optimizers(cfg, agent)
    if state is not None:
        p2e_convert.load_checkpoint_state(state, models, opts)
    step = expl.make_train_step(agent, opts, cfg, is_continuous)
    return types.SimpleNamespace(
        modules=[getattr(agent, k) for k in p2e_dv2_exploration.TRAINED],
        state=lambda: p2e_convert.checkpoint_state(models, opts),
        step=step,
        make_fn=lambda inputs, gen: p2e_dv2_exploration.make_train_fn(step, agent, opts, inputs, gen),
        refresh=(lambda: p2e_dv2_exploration.refresh_targets(agent)) if exp == "p2e_dv2_exploration" else (lambda: None),
        order=expl.METRIC_ORDER,
    )


def phase_family_step(torch, np, fg, rb, obs_space, actions_dim, is_continuous, exp: str) -> dict:
    """18(a), (b) one gradient step of ``exp`` at its widths, bf16-mixed, on
    REPLAYED_STEPS batches of phase 6's PixelCatcher replay
    (``FAMILY_STEPS``): replays of its CUDA graph against as many eager
    steps from the same weights, smooth samplers and cuDNN's deterministic
    algorithms (metrics and every trained parameter within REPLAY_BOUND;
    P2E-DV2's targets hard-copied before each step on both sides); ms a
    replay, a profiler window (idle share, kernel count, top kernels), and
    neither B1 nor B2 launched by any of it (the recurrent models are
    flax's plain GRU cells)."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import to_batch

    dev = torch.device("cuda")
    B, T = FAMILY_STEPS[exp]
    batches = [to_batch(rb.sample(B, sequence_length=T), ["rgb"], dev) for _ in range(REPLAYED_STEPS)]
    cfg = family_cfg(exp)
    report = {"exp": exp, "B": B, "T": T, "horizon": int(cfg.algo.horizon), "precision": BF16, "replay_bound": REPLAY_BOUND}
    if "ensembles" in cfg.algo:
        report["ensemble_members"] = int(cfg.algo.ensembles.n)
    fg.reset_launch_count()
    with cudnn_deterministic(torch), family_deterministic():
        graphed = family_models(torch, exp, cfg, obs_space, actions_dim, is_continuous)
        eager = family_models(torch, exp, cfg, obs_space, actions_dim, is_continuous, graphed.state())
        fn = graphed.make_fn({k: v.clone() for k, v in batches[0].items()}, None)
        metric_errs = []
        for b in batches:
            for k, v in b.items():
                fn.inputs[k].copy_(v)
            graphed.refresh()
            eager.refresh()
            got = fn()
            want = eager.step(b, None)
            metric_errs.append(rel_err(torch, got, want))
        torch.cuda.synchronize()
        params = lambda ns: [p for m in ns.modules for p in m.parameters()]  # noqa: E731
        param_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(params(graphed), params(eager)))
        report["replayed_vs_eager"] = {
            "metric_max_rel_err_per_step": metric_errs,
            "param_max_rel_err": param_err,
            "metrics": dict(zip(graphed.order, got.tolist())),
            "replays": fn.replays,
        }
        if max(metric_errs + [param_err]) > REPLAY_BOUND or not torch.isfinite(got).all():
            raise AssertionError(f"18 the {exp} step replayed against eager: {report['replayed_vs_eager']}")
        del graphed, eager, fn
    torch.cuda.empty_cache()
    models = family_models(torch, exp, cfg, obs_space, actions_dim, is_continuous)
    fn = models.make_fn({k: v.clone() for k, v in batches[0].items()}, torch.Generator(device="cuda").manual_seed(SEED))
    fn()
    report["ms_per_replay"] = [step_ms(torch, fn), step_ms(torch, fn)]
    report["profile"] = profile_replays(torch, fn, replays=2, top=12)
    report["fused_gru_launches"] = fg.launch_count
    report["sharded_proj_launches"] = fg.proj_launch_count
    report["card"] = card_line()
    print(f"phase 18 {exp}_step " + json.dumps(report), flush=True)
    if fg.launch_count != 0 or fg.proj_launch_count != 0 or report["profile"]["gru_step_kernels_per_replay"] != 0:
        raise AssertionError(f"18 the {exp} step launched B1 {fg.launch_count} and B2 {fg.proj_launch_count} times")
    del models, fn
    torch.cuda.empty_cache()
    return report


def phase_family_cli(torch, np, fg, tmp: str) -> dict:
    """18(c) ``exp=dreamer_v1``, ``exp=p2e_dv2_exploration`` then
    ``exp=p2e_dv2_finetuning`` from its checkpoint, and the same two for
    P2E-DV1, on ``env=pixel_catcher`` through ``cli.run``, each cut to
    FAMILY_CUTS with its test episode, then ``cli_eval`` of each run's
    checkpoint: env-steps/s over the loop and steady (the updates after
    the first train window, which captured the step), gradient steps, the
    replay, the finetuning player's switch to the task actor, the run
    records, and neither B1 nor B2 launched."""
    import glob
    import importlib
    import io

    from sheeprl_tpu_torch import cli

    common = {**FAMILY_CUTS, "seed": SEED, "log_base_dir": f"{tmp}/logs", "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl"}
    report = {"card": card_line(), "cuts": FAMILY_CUTS, "runs": {}}
    ckpts = {}
    for name in FAMILY_RUNS:
        pkg = "p2e_" + name.split("_")[1] if name.startswith("p2e") else name
        module = importlib.import_module(f"sheeprl_tpu_torch.algos.{pkg}.{name}")
        extra = [f"checkpoint.exploration_ckpt_path={ckpts[name.replace('finetuning', 'exploration')]}"] if "finetuning" in name else []
        argv = [f"exp={name}", "env=pixel_catcher", "env.id=pixel_catcher", f"run_name={name}", *extra] + [f"{k}={v}" for k, v in common.items()]
        out, calls, _, seconds = cli_in_process(torch, fg, argv, module)
        found = sorted(glob.glob(f"{out['log_dir']}/checkpoint/*.ckpt"))
        num_envs = int(family_cfg(name, *extra).env.num_envs)
        later = out["update_seconds"][FAMILY_CUTS["algo.learning_starts"] // num_envs :]
        row = {
            "env_steps": out["env_steps"],
            "gradient_steps": out["gradient_steps"],
            "replays": out["replays"],
            "env_steps_per_s": out["env_steps"] / out["seconds"],
            "env_steps_per_s_steady": num_envs * len(later) / sum(later) if later else None,
            "run_seconds": seconds,
            "loop_seconds": out["seconds"],
            "train_seconds": out["train_seconds"],
            "replay_buffer": out["replay_buffer"],
            "player_device": out["player_device"],
            "fused_gru_calls": calls,
            # cli_in_process set the counts to 0 just before the run
            "sharded_proj_calls": fg.proj_launch_count,
            "test_steps": out["test_steps"],
            "last_metrics_finite": bool(out["metrics"]) and all(math.isfinite(v) for v in out["metrics"].values()),
        }
        if "finetuning" in name:
            row["player_switched_to_task_actor_at_policy_step"] = out["switched_at"]
        report["runs"][name] = row
        print(f"phase 18(c) {name}_cli " + json.dumps(row), flush=True)
        if (
            out["env_steps"] != FAMILY_CUTS["algo.total_steps"]
            or out["gradient_steps"] <= 0
            or out["replays"] != out["gradient_steps"]
            or calls != 0
            or row["sharded_proj_calls"] != 0
            or not row["last_metrics_finite"]
            or not found
            or out["test_steps"] <= 0
            or ("finetuning" in name and out["switched_at"] != FAMILY_CUTS["algo.learning_starts"] + num_envs)
        ):
            raise AssertionError(f"18(c) exp={name}: {row}")
        ckpts[name] = found[-1]
    evals = {}
    fg.reset_launch_count()
    for name in FAMILY_RUNS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.evaluation([f"checkpoint_path={ckpts[name]}", f"env.max_episode_steps={EVAL_CAP}"])
        torch.cuda.synchronize()
        evals[name] = {"episode_played": "Test - Reward:" in buf.getvalue(), "seconds": time.perf_counter() - t0}
    report["cli_eval"] = {"runs": evals, "fused_gru_launches": fg.launch_count, "sharded_proj_launches": fg.proj_launch_count}
    records = [json.loads(line) for line in open(f"{tmp}/RUNS.jsonl")]
    report["records"] = [[r["kind"], r["algo"], r["outcome"]] for r in records]
    print("phase 18(c) family_cli " + json.dumps({k: report[k] for k in ("cli_eval", "records", "cuts")}), flush=True)
    want = [["train", n, "completed"] for n in FAMILY_RUNS] + [["eval", n, "completed"] for n in FAMILY_RUNS]
    if not all(e["episode_played"] for e in evals.values()) or fg.launch_count != 0 or fg.proj_launch_count != 0 or report["records"] != want:
        raise AssertionError(f"18(c) cli_eval or run records: {report['cli_eval']}, {report['records']}")
    return report


# --------------------------------------------------------------------------- #
# phase 19: the replica fleet (serve.fleet.enabled) over phase 12's exp=ppo
# MLP checkpoint, bf16-mixed
# --------------------------------------------------------------------------- #

# two device replicas on the card, one CPU-spill replica, one standby slot
# the autoscaler may activate; the drills' fast scans (tests/test_serve's
# DRILL_FLEET cadences)
FLEET_NODE = {"enabled": True, "num_replicas": 2, "min_replicas": 2, "max_replicas": 3, "cpu_spill_replicas": 1, "hedge_scan_ms": 2.0, "autoscale_interval_s": 0.05}
FLEET_LOAD_S = 3.0  # the CLI's closed loop
# the CLI's ramp: 500..8000 Hz, 1 s a step, 32 open-loop clients (8 of
# them offered at most about 1900 requests/s from an H100 machine's host)
FLEET_RAMP = {"ramp_steps": 5, "ramp_start_hz": 500.0, "ramp_factor": 2.0, "duration_s": 5.0, "concurrency": 32}
FLEET_KILL_RATES = (250.0, 500.0, 1000.0)  # the kill drill's ramp, replica 0 killed as step 1 begins
FLEET_KILL_STEP_S = 1.0
FLEET_BURST = 96  # requests of the autoscale drill's burst
FLEET_SWAP_TRAFFIC_S = 1.0  # traffic before and after the hot swap
FLEET_BUDGET_S = 60.0  # what phase 19 may add to the smoke


def fleet_config(**fleet):
    """``serve_config`` (phase 15's ladder and cadences) with the fleet on:
    ``FLEET_NODE`` under the keys given; a ``serve`` key's dict merges into
    the serve node."""
    serve = fleet.pop("serve", {})
    return serve_config(fleet={**FLEET_NODE, **fleet}, **serve)


def fleet_server(served: dict, cfg, on_event=None):
    """A started fleet over ``served``; the smoke's heap (earlier phases'
    garbage) is collected first, so a full collection does not land inside
    a drill's timed window."""
    import gc

    from sheeprl_tpu_torch.serve.fleet import FleetServer

    gc.collect()
    ckpt = served["ckpt"]
    return FleetServer(served["policy"], cfg, step=ckpt.step, path=ckpt.path, on_event=on_event).start()


def fleet_slot_parity(np, server, plain_card, plain_cpu, slots) -> dict:
    """Each of ``slots``' rungs held to the same rung run eagerly (bit for
    bit) and to the plain forward on the slot's device (equal): the card's
    for a device slot, the CPU's for the spill slot; for the spill slot the
    rows equal to the card's plain forward are counted too."""
    rows = {}
    for index in slots:
        slot, ladder = server.slots[index], server.store.current.ladders[index]
        row = {"kind": slot.kind, "device": str(slot.device), "rungs": {}}
        for b in SERVE_LADDER:
            obs = serve_obs(np, server.policy, b, seed=100 + b)
            rung = ladder.rung(b)
            got, eager = rung.run(obs), rung.eager(obs)
            want = (plain_cpu if slot.kind == "cpu_spill" else plain_card)(obs)
            if not (np.array_equal(got, eager) and np.array_equal(got.astype(want.dtype), want)):
                raise AssertionError(f"19(a) slot {index} ({slot.kind}) rung {b}: replay {got} eager {eager} plain {want}")
            row["rungs"][b] = {"bit_equal_to_eager": True, "equal_to_plain": True}
            if slot.kind == "cpu_spill":
                card = plain_card(obs)
                row["rungs"][b]["rows_equal_to_card_plain"] = int((got.astype(card.dtype) == card).all(axis=-1).sum())
        rows[index] = row
    return rows


def fleet_run_checks(label: str, report: dict, snap: dict, slo_ms: float) -> None:
    """Zero admitted requests dropped or expired, no client error, and the
    fleet's p95 within the SLO."""
    steps = report.get("steps", [report])
    expired, errors = sum(s["expired"] for s in steps), sum(s["errors"] for s in steps)
    if expired or errors or snap["shed_expired"] or snap["failed"] or snap["p95_ms"] is None or snap["p95_ms"] > slo_ms:
        seen = {k: snap[k] for k in ("shed_expired", "failed", "p95_ms")}
        raise AssertionError(f"19 {label}: expired {expired} errors {errors} {seen}")


def equal_to_a_plain(np, plains, obs: list, got) -> int:
    """Rows of ``got`` equal to one of ``plains`` (plain forwards, each on
    its device) over ``obs`` at one of the ladder's batch sizes: a slot's
    rung pads its batch, and a row is computed within that batch."""
    ok = np.zeros(len(obs), dtype=bool)
    for fn in plains:
        for b in reversed(SERVE_LADDER):  # the widest first: the fewest forwards
            todo = np.flatnonzero(~ok)
            if not len(todo):
                return len(obs)
            want = plain_at(np, fn, [obs[i] for i in todo], b)
            ok[todo] |= (got[todo].astype(want.dtype) == want).all(axis=-1)
    return int(ok.sum())


def phase_fleet_cli(torch, tmp: str, ckpt_dir: str) -> dict:
    """19(b) ``serve ckpt_dir=... serve.fleet.enabled=true
    serve.load.enabled=true`` through ``cli.run``: a closed loop at
    concurrency 8 for ``FLEET_LOAD_S``, then a stepped ramp (``FLEET_RAMP``):
    QPS, p50/p95 against ``slo_ms``, the knee and ``max_good_qps``, hedges,
    re-routes and sheds, the hedge scan's lag, the ``variant: fleet`` run
    record."""
    fleet = [f"serve.fleet.{k}={str(v).lower() if isinstance(v, bool) else v}" for k, v in FLEET_NODE.items()]
    report = {"card": card_line()}
    runs = {
        "closed_loop": (f"serve.load.duration_s={FLEET_LOAD_S}",),
        "ramp": tuple(f"serve.load.{k}={v}" for k, v in FLEET_RAMP.items()),
    }
    import gc

    for run, extra in runs.items():
        gc.collect()  # as fleet_server does
        out = serve_cli(tmp, ckpt_dir, f"fleet_{run}", *fleet, *extra)
        snap, load = out["snap"], out["snap"]["load_report"]
        router = snap["fleet"]["router"]
        row = {
            "qps": snap["qps"] if run == "ramp" else load["qps"],
            "p50_ms": snap["p50_ms"] if run == "ramp" else load["p50_ms"],
            "p95_ms": snap["p95_ms"] if run == "ramp" else load["p95_ms"],
            "slo_ms": load["slo_ms"],
            "mean_batch": snap["mean_batch"],
            "completed": snap["completed"],
            "shed_overloaded": snap["shed_overloaded"],
            "shed_expired": snap["shed_expired"],
            **{k: router[k] for k in ("routed", "hedged", "hedged_won", "rerouted_requests", "spilled", "hedge_threshold_ms", "scan_lag_ms")},
            "warmup_s": snap["warmup_s"],
            "record_kind": out["record"]["kind"],
            "record_variant": out["record"].get("variant"),
            "record_outcome": out["record"]["outcome"],
            "banner": out["banner"],
            "process_seconds": out["seconds"],
        }
        if run == "ramp":
            row.update({k: load[k] for k in ("offered_rates_hz", "knee_rate_hz", "max_good_qps", "saturated")})
            row["steps"] = [{k: s[k] for k in ("offered_rate_hz", "qps", "p50_ms", "p95_ms", "ok", "shed", "expired", "errors", "goodput_frac", "slo_met")} for s in load["steps"]]
        else:
            row.update({k: load[k] for k in ("ok", "shed", "expired", "errors", "slo_met", "client_retries")})
        report[run] = row
        print(f"phase 19(b) fleet_cli_{run} " + json.dumps(row), flush=True)
        # a ramp offers past the knee, where sheds and expiries are its
        # finding; any other client error, or a closed loop's expiry, fails
        steps = load.get("steps", [load])
        lost = sum(st["errors"] for st in steps) + (0 if run == "ramp" else load["expired"])
        if (row["record_kind"], row["record_variant"], row["record_outcome"]) != ("serve", "fleet", "completed") or snap["completed"] <= 0 or lost:
            raise AssertionError(f"19(b) fleet CLI {run}: {row}")
        if run == "ramp" and (row["knee_rate_hz"] is None or row["max_good_qps"] <= 0):
            raise AssertionError(f"19(b) fleet ramp found no knee: {row}")
    return report


def phase_fleet_drills(torch, np, served: dict, plain_card, plain_cpu, part_took) -> dict:
    """19(c) the drills, each on a fleet of its own over the same weights:
    (1) replica 0 killed as the second step of an open-loop ramp begins
    (``FLEET_KILL_RATES``, the fleet pinned at two device replicas, no
    restart budget): zero admitted requests dropped or expired and the
    survivors' p95 within the SLO; (2) ``router_blackhole`` for 50 ms from
    the 10th request: every request served, rescued by the hedge scan; (3)
    autoscale: a burst of ``FLEET_BURST`` requests over slowed replicas
    activates the standby slot (its graphs captured first, the serving
    pause printed, its rungs then held as in (a)), and the idle fleet
    retires it, no request expiring; (4) ``batch`` traffic with the spill
    tier open (``spill_depth`` 0) and hedging off, served by the CPU-spill
    slot, its answers equal to the plain forward on the CPU; (5) a hot swap under mixed load
    (interactive threads on the device slots, ``batch`` threads on the
    spill slot): nothing dropped, every answer equal to the plain forward
    of the version stamped on it (on the slot's device), every slot's
    graphs serving the new version after the flip."""
    import threading

    from sheeprl_tpu_torch.serve.config import LoadConfig
    from sheeprl_tpu_torch.serve.loadgen import random_obs, run_load, run_ramp

    policy = served["policy"]
    spill = FLEET_NODE["max_replicas"]  # spill slots follow the device slots
    report = {}

    # (1) kill mid-ramp
    server = fleet_server(served, fleet_config(num_replicas=2, min_replicas=2, max_replicas=2, max_pending=10_000, serve={"max_restarts": 0, "restart_refund_s": None}))
    killed = []
    try:
        ramp = run_ramp(
            server,
            LoadConfig(enabled=True, concurrency=8, max_retries=5, seed=0),
            rates_hz=list(FLEET_KILL_RATES),
            step_duration_s=FLEET_KILL_STEP_S,
            on_step=lambda step, rate: killed.append(server.kill_replica(0)) if step == 1 else None,
        )
        time.sleep(0.1)
        snap = server.snapshot()
    finally:
        server.close()
    router = snap["fleet"]["router"]
    report["kill_mid_ramp"] = {
        "killed": killed,
        "replicas_alive": snap["replicas_alive"],
        "steps": [{k: s[k] for k in ("offered_rate_hz", "qps", "p50_ms", "p95_ms", "ok", "shed", "expired", "errors", "slo_met")} for s in ramp["steps"]],
        "knee_rate_hz": ramp["knee_rate_hz"],
        "p95_ms": snap["p95_ms"],
        "slo_ms": snap["slo_ms"],
        **{k: router[k] for k in ("rerouted_requests", "hedged", "shed", "scan_lag_ms")},
        "events": snap["events"],
    }
    print("phase 19(c) fleet_kill_mid_ramp " + json.dumps(report["kill_mid_ramp"]), flush=True)
    fleet_run_checks("kill mid-ramp", ramp, snap, snap["slo_ms"])
    if killed != [True] or snap["replicas_alive"] != 2:  # the survivor and the spill slot
        raise AssertionError(f"19(c) kill mid-ramp: {report['kill_mid_ramp']}")
    part_took("19c_kill")

    # (2) router blackhole (device slots only: every answer from the card)
    cfg = fleet_config(cpu_spill_replicas=0, serve={"fault_injection": {"enabled": True, "faults": [{"kind": "router_blackhole", "at_request": 10, "duration_s": 0.05}]}})
    server = fleet_server(served, cfg)
    try:
        obs = serve_obs(np, policy, 40, seed=3)
        reqs = [server.submit(o) for o in obs]
        out = np.stack([server.wait(r) for r in reqs])
        snap = server.snapshot()
    finally:
        server.close()
    router = snap["fleet"]["router"]
    report["router_blackhole"] = {"requests": len(obs), "completed": snap["completed"], "blackholed": router["blackholed"], "rescued": snap["events"].get("router_rescue", 0), "equal_to_plain": equal_to_a_plain(np, [plain_card], obs, out) == len(obs), "failed": snap["failed"]}
    print("phase 19(c) fleet_router_blackhole " + json.dumps(report["router_blackhole"]), flush=True)
    row = report["router_blackhole"]
    # the scan also places requests that found every pool full
    if row["completed"] != len(obs) or not row["blackholed"] or row["rescued"] < row["blackholed"] or row["failed"] or not row["equal_to_plain"]:
        raise AssertionError(f"19(c) router_blackhole: {row}")
    part_took("19c_blackhole")

    # (3) autoscale up under pressure, then down when idle
    slow = [{"kind": "slow_inference", "replica": r, "at_batch": 0, "duration_s": 0.01, "for_batches": 12} for r in (0, 1)]
    cfg = fleet_config(cpu_spill_replicas=0, backlog_per_replica=64, max_pending=10_000, scale_up_depth=4.0, scale_down_depth=0.5, scale_patience=1, autoscale_interval_s=0.02, serve={"fault_injection": {"enabled": True, "faults": slow}})
    server = fleet_server(served, cfg)
    try:
        standby_before = server.store.has_graphs(2)
        obs = serve_obs(np, policy, FLEET_BURST, seed=4)
        reqs = [server.submit(o) for o in obs]
        out = np.stack([server.wait(r) for r in reqs])
        deadline = time.monotonic() + 10.0
        while server.scale_downs < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = server.snapshot()
        activated = fleet_slot_parity(np, server, plain_card, plain_cpu, [2]) if server.store.has_graphs(2) else {}
    finally:
        server.close()
    report["autoscale"] = {
        "standby_captured_before": standby_before,
        "scale_ups": snap["fleet"]["scale_ups"],
        "scale_downs": snap["fleet"]["scale_downs"],
        "active_device_replicas_after": snap["fleet"]["active_device_replicas"],
        "slot_captures": snap["fleet"]["slot_captures"],
        "completed": snap["completed"],
        "shed_expired": snap["shed_expired"],
        "failed": snap["failed"],
        "p95_ms": snap["p95_ms"],
        "equal_to_plain": equal_to_a_plain(np, [plain_card], obs, out) == len(obs),
        "activated_slot": activated,
    }
    print("phase 19(c) fleet_autoscale " + json.dumps(report["autoscale"]), flush=True)
    row = report["autoscale"]
    if standby_before or row["scale_ups"] < 1 or row["scale_downs"] < 1 or row["active_device_replicas_after"] != 2 or not row["slot_captures"] or row["shed_expired"] or row["failed"] or row["completed"] != FLEET_BURST or not row["equal_to_plain"] or not activated:
        raise AssertionError(f"19(c) autoscale: {row}")
    part_took("19c_autoscale")

    # (4) batch traffic on the spill slot
    # no hedging here: a hedge twin would take a request to a device slot
    server = fleet_server(served, fleet_config(spill_depth=0, backlog_per_replica=64, hedge_max=0))
    try:
        obs = serve_obs(np, policy, 32, seed=5)
        reqs = [server.submit(o, priority="batch") for o in obs]
        out = np.stack([server.wait(r) for r in reqs])
        placements = [r.placements for r in reqs]
        load = run_load(server, LoadConfig(enabled=True, duration_s=1.0, concurrency=4, seed=5), priority="batch")
        snap = server.snapshot()
    finally:
        server.close()
    router = snap["fleet"]["router"]
    report["cpu_spill"] = {
        "requests": len(obs),
        "on_spill_slot": sum(p == [spill] for p in placements),
        "equal_to_cpu_plain": equal_to_a_plain(np, [plain_cpu], obs, out) == len(obs),
        "load_ok": load["ok"],
        "load_qps": load["qps"],
        "load_p50_ms": load["p50_ms"],
        "load_p95_ms": load["p95_ms"],
        "spilled": router["spilled"],
        "routed": router["routed"],
        "spill_slot_requests": snap["fleet"]["replicas"][spill]["requests"],
    }
    print("phase 19(c) fleet_cpu_spill " + json.dumps(report["cpu_spill"]), flush=True)
    row = report["cpu_spill"]
    if row["on_spill_slot"] != len(obs) or not row["equal_to_cpu_plain"] or not row["spilled"] == row["routed"] == row["spill_slot_requests"] or load["errors"] or load["ok"] <= 0:
        raise AssertionError(f"19(c) cpu spill: {row}")
    part_took("19c_spill")

    # (5) hot swap across every slot under mixed load
    report["hot_swap"] = row = fleet_hot_swap(torch, np, served, plain_card, plain_cpu)
    print("phase 19(c) fleet_hot_swap " + json.dumps(row), flush=True)
    if not row["ok"]:
        raise AssertionError(f"19(c) hot swap across every slot: {row}")
    part_took("19c_swap")
    return report


def fleet_hot_swap(torch, np, served: dict, plain_card, plain_cpu) -> dict:
    """19(c)(5) a hot swap across every slot under mixed load, on a fleet of
    its own; its row, ``ok`` false where a request failed, expired or got
    an answer other than the plain forward of the version stamped on it,
    or a slot kept the old version. Each pause is in ``swap_pause_parts``
    by part (``ModelStore._build_version``), beside the slot captures and
    scale-ups the autoscaler made, each at its seconds from the swap's
    request (``events``)."""
    import threading

    from sheeprl_tpu_torch.serve.loadgen import random_obs

    policy = served["policy"]
    spill = FLEET_NODE["max_replicas"]  # spill slots follow the device slots
    new_step = served["ckpt"].step + 2000
    new_path, new_state = commit_perturbed(np, served, new_step)
    plains = {
        served["ckpt"].step: (plain_card, plain_cpu),
        new_step: (served["plain"](new_state["agent"]), served["plain"](new_state["agent"], device="cpu")),
    }
    events = []
    server = fleet_server(served, fleet_config(spill_depth=0), on_event=lambda kind, info: events.append((kind, info, time.perf_counter())))
    stop = threading.Event()
    records, failures = [], []

    def traffic(seed: int, priority: str) -> None:
        make, rng = random_obs(policy.obs_spec), np.random.default_rng(2000 + seed)
        while not stop.is_set():
            o = make(rng)
            try:
                req = server.submit(o, priority=priority)
                out = server.wait(req)
                records.append((o, out, req.served_step, priority))
            except Exception as err:  # the drill counts every failure
                failures.append(repr(err))

    threads = [threading.Thread(target=traffic, args=(i, "batch" if i % 2 else "interactive"), daemon=True) for i in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(FLEET_SWAP_TRAFFIC_S)
        t0 = time.perf_counter()
        server.request_swap(new_path)
        swap_s = time.perf_counter() - t0
        time.sleep(FLEET_SWAP_TRAFFIC_S)
        stop.set()
        for t in threads:
            t.join(10.0)
        snap = server.snapshot()
        probe = serve_obs(np, policy, 1, seed=6)
        after = {i: np.stack(lad.run(probe)) for i, lad in enumerate(server.store.current.ladders) if lad is not None}
    finally:
        stop.set()
        server.close()
    if any(t.is_alive() for t in threads):
        raise AssertionError("19(c) hot swap: a traffic thread did not stop")
    matches, by_version = 0, {}
    for step, fns in plains.items():
        idx = [i for i, r in enumerate(records) if r[2] == step]
        by_version[step] = len(idx)
        if idx:
            matches += equal_to_a_plain(np, fns, [records[i][0] for i in idx], np.stack([records[i][1] for i in idx]))
    new_card, new_cpu = plains[new_step]
    slots_on_new = {i: bool(np.array_equal(out.astype(int), (new_cpu if server.slots[i].kind == "cpu_spill" else new_card)(probe).astype(int))) for i, out in after.items()}
    swaps = [info for kind, info, _ in events if kind == "swap"]
    row = {
        "requests": len(records),
        "batch_priority_requests": sum(r[3] == "batch" for r in records),
        "failures": len(failures),
        "first_failures": failures[:3],
        "answers_by_version": by_version,
        "equal_to_plain_of_stamped_version": matches,
        "request_swap_s": swap_s,
        "swap_capture_s": [info["capture_s"] for info in swaps],
        "swap_pause_s": [info["pause_s"] for info in swaps],
        "swap_pauses_s": [info["pauses_s"] for info in swaps],
        "swap_pause_parts": [info["pause_parts"] for info in swaps],
        "events": [
            {"kind": kind, "at_s": at - t0, **{k: v for k, v in info.items() if k in ("replica", "pause_s", "pause_parts")}}
            for kind, info, at in events
            if kind in ("slot_capture", "fleet_scale_up", "fleet_scale_down", "swap")
        ],
        "slots_serving_new_version": slots_on_new,
        "shed_expired": snap["shed_expired"],
        "failed": snap["failed"],
        "serving_step": snap["serving_step"],
        "p95_ms": snap["p95_ms"],
    }
    # every captured slot: the two device slots and the spill slot, and the
    # standby slot too when the autoscaler activated it under this load
    row["ok"] = not (
        failures or snap["shed_expired"] or snap["failed"] or matches != len(records) or not all(by_version.values())
        or snap["serving_step"] != new_step or not all(slots_on_new.values()) or not {0, 1, spill} <= set(slots_on_new)
        or not row["batch_priority_requests"]
    )
    return row


SWAP_DRILLS = 20  # back-to-back runs of 19(c)'s hot swap (``--swap-drills``)


def swap_drill_repeats(runs: int = SWAP_DRILLS) -> int:
    """``python3 chip_smoke.py --swap-drills N``: phase 12(b)'s PPO run for
    a checkpoint, then 19(c)'s hot swap ``runs`` times back to back, each
    run's pauses printed by part (each run's whole row in
    ``chiprun_out/swap_drills.jsonl``); exits non-zero if any run dropped or
    expired a request. On the card only."""
    import os
    import tempfile

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    tmp = tempfile.mkdtemp()
    steps = 128 * 4 * PPO_CLI_UPDATES
    ppo_cli(torch, tmp, SERVE_RUNS["mlp_cartpole"], ["exp=ppo", "env.backend=sync", "metric.log_level=1", f"algo.total_steps={steps}"])
    served = serve_model(torch, np, serve_ckpt_dir(tmp, SERVE_RUNS["mlp_cartpole"]))
    plain_card = served["plain"](served["state"]["agent"])
    plain_cpu = served["plain"](served["state"]["agent"], device="cpu")
    os.makedirs("chiprun_out", exist_ok=True)
    failed, longest = [], None
    with open(os.path.join("chiprun_out", "swap_drills.jsonl"), "w") as out:
        for run in range(runs):
            row = fleet_hot_swap(torch, np, served, plain_card, plain_cpu)
            out.write(json.dumps({"run": run, **row}) + "\n")
            pauses = [p for e in row["events"] if e["kind"] in ("swap", "slot_capture") for p in e["pause_parts"]]
            top = max(pauses, key=lambda p: p["pause_s"])
            if longest is None or top["pause_s"] > longest["pause_s"]:
                longest = {"run": run, **top}
            brief = {k: row[k] for k in ("ok", "requests", "failures", "shed_expired", "request_swap_s")}
            brief["pauses"] = [(p["slot"], round(p["pause_s"], 4), round(p["gate_wait_s"], 4), {k: round(v, 4) for k, v in p["parts"].items()}) for p in pauses]
            print(f"swap drill {run} " + json.dumps(brief), flush=True)
            if not row["ok"]:
                failed.append(run)
    print("swap drills longest pause " + json.dumps(longest), flush=True)
    print(f"swap drills: {runs - len(failed)} of {runs} passed; failed runs {failed}; {card_line()}", flush=True)
    return 1 if failed else 0


def phase_fleet(torch, np, fg, tmp: str, serve: dict, part_took) -> dict:
    """Phase 19: (a) every slot's rungs, (b) the CLI's closed loop and ramp,
    (c) the drills, beside phase 15's single-server figures; the fleet
    launches neither B1 nor B2 (checked)."""
    b1_before, b2_before = fg.launch_count, fg.proj_launch_count
    t0 = time.perf_counter()
    report = {"card": card_line()}
    ckpt_dir = serve_ckpt_dir(tmp, SERVE_RUNS["mlp_cartpole"])
    served = serve_model(torch, np, ckpt_dir)
    plain_card = served["plain"](served["state"]["agent"])
    plain_cpu = served["plain"](served["state"]["agent"], device="cpu")
    server = fleet_server(served, fleet_config())
    try:
        report["slots"] = fleet_slot_parity(np, server, plain_card, plain_cpu, [0, 1, FLEET_NODE["max_replicas"]])
        report["warmup_s"] = dict(server.warmup_s)
        report["standby_captured_at_start"] = server.store.has_graphs(2)
    finally:
        server.close()
    print("phase 19(a) fleet_slots " + json.dumps(report["slots"]), flush=True)
    if report["standby_captured_at_start"]:
        raise AssertionError("19(a) the standby slot was captured before its activation")
    part_took("19a")
    report["cli"] = phase_fleet_cli(torch, tmp, ckpt_dir)
    part_took("19b")
    report["drills"] = phase_fleet_drills(torch, np, served, plain_card, plain_cpu, part_took)
    if (fg.launch_count, fg.proj_launch_count) != (b1_before, b2_before):
        raise AssertionError(f"phase 19 launched B1 {fg.launch_count - b1_before} and B2 {fg.proj_launch_count - b2_before} times, want 0")
    single = {k: serve["cli"]["closed_loop"][k] for k in ("qps", "p50_ms", "p95_ms", "slo_ms", "mean_batch")}
    fleet = {k: report["cli"]["closed_loop"][k] for k in ("qps", "p50_ms", "p95_ms", "slo_ms", "mean_batch")}
    print(f"phase 19 {report['card']} closed loop, concurrency 8: fleet " + json.dumps(fleet) + " single server (phase 15) " + json.dumps(single), flush=True)
    print("phase 19 b1_b2_launches 0", flush=True)
    report["seconds"] = time.perf_counter() - t0
    print(f"phase 19 took {report['seconds']:.1f} s of its {FLEET_BUDGET_S:.0f} s budget", flush=True)
    return report



# --------------------------------------------------------------------------- #
# phase 20: the flagship's own default configs (classic-control pixels), the
# triggered and whole-run profilers, model registration and cli_agents
# --------------------------------------------------------------------------- #

# exp=dreamer_v3 and exp=sac_ae as composed, cut in depth only
PIXEL_CUTS = {"algo.total_steps": 288, "algo.learning_starts": 256, "buffer.size": 4096}
SAC_AE_PIXEL_CUTS = {"algo.total_steps": 160, "algo.learning_starts": 64, "buffer.size": 20000}
# the traced window (1-based loop iterations of 4 env steps): after the
# first train window, iteration 64, which captures the step
PROFILE_WINDOW = 70
# the whole-run trace's PPO: 2 updates of 32 x 4 env steps (from 128 x 4:
# the published rollout's trace held 89756 kernel events, 245 MB of JSON)
PPO_PROFILED_UPDATES = 2
PPO_PROFILED_ROLLOUT = 32
FRAMES_TIMED = 100
REGISTERED_ALGORITHMS = 15


def trace_kernels(path: str) -> list:
    """The names of a Chrome trace's CUDA kernel events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def tree_equal(np, a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(tree_equal(np, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(tree_equal(np, x, y) for x, y in zip(a, b))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def frame_ms(np, exp: str, env_id: str = "") -> float:
    """Host ms an env step of ``exp``'s env as composed (with ``env.id``
    ``env_id`` where given): the classic dynamics, the frame drawn and
    resized to 64 x 64 (and stacked)."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.utils.utils import dotdict

    cfg = dotdict(compose("config", [f"exp={exp}", "env.capture_video=False", *([f"env.id={env_id}"] if env_id else [])]))
    env = make_env(cfg, SEED)()
    env.reset(seed=SEED)
    env.action_space.seed(SEED)
    env.step(env.action_space.sample())
    t0 = time.perf_counter()
    for _ in range(FRAMES_TIMED):
        _, _, terminated, truncated, _ = env.step(env.action_space.sample())
        if terminated or truncated:
            env.reset()
    ms = (time.perf_counter() - t0) / FRAMES_TIMED * 1e3
    env.close()
    return ms


def phase_default_configs(torch, np, fg, tmp: str, part_took) -> dict:
    """Phase 20 (the module docstring's item 20): (a) to (f)."""
    import glob
    import io
    import os
    import pickle

    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.ppo import ppo
    from sheeprl_tpu_torch.algos.sac_ae import sac_ae
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    report = {"card": card_line(), "cuts": {"dreamer_v3": PIXEL_CUTS, "sac_ae": SAC_AE_PIXEL_CUTS}}
    common = {"seed": SEED, "env.capture_video": False, "log_base_dir": f"{tmp}/logs", "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl"}

    # (a) exp=dreamer_v3 as composed, one window traced
    argv = ["exp=dreamer_v3", "run_name=dv3_pixels", "metric.telemetry.enabled=True", f"metric.telemetry.profile_windows=[{PROFILE_WINDOW}]"]
    argv += [f"{k}={v}" for k, v in {**PIXEL_CUTS, **common}.items()]
    out, calls, bf16_calls, seconds = cli_in_process(torch, fg, argv, dv3)
    launches = main_path_launches(out, calls)
    captured = out["captured_launches_per_step"]
    bf16_launches = bf16_calls - captured + captured * out["replays"]
    record = [json.loads(line) for line in open(f"{tmp}/RUNS.jsonl")][-1]
    (capture,) = record.get("profile_captures") or [None]
    kernels = trace_kernels(f"{capture['trace_dir']}/trace.json") if capture else []
    spans = [json.loads(line) for line in open(record["telemetry_jsonl"])]
    train = {e["step"]: e["dur"] for e in spans if e.get("event") == "span" and e.get("name") == "Time/train_time"}
    # window w's spans carry the policy step at its start, 4 (w - 1); the
    # untraced windows compared are the later ones after the capture
    traced_step = (PROFILE_WINDOW - 1) * 4
    untraced = sorted(d for st, d in train.items() if st >= (PROFILE_WINDOW - 5) * 4 and st != traced_step)
    row = {
        "env_steps": out["env_steps"],
        "gradient_steps": out["gradient_steps"],
        "replays": out["replays"],
        "env_steps_per_s": out["env_steps"] / out["seconds"],
        "run_seconds": seconds,
        "fused_gru_wrapper_calls": calls,
        "fused_gru_launches": launches,
        "fused_gru_bf16_x_launches": bf16_launches,
        "profile_capture": capture,
        "profile_failed_starts": record.get("profile_failed_starts", 0),
        "trace_kernel_events": len(kernels),
        "trace_gru_step_kernels": sum("gru_step" in k for k in kernels),
        "traced_window_train_ms": train.get(traced_step, float("nan")) * 1e3,
        "untraced_window_train_ms_median": untraced[len(untraced) // 2] * 1e3 if untraced else None,
        "capture_wall_s": capture["t_end"] - capture["t_start"] if capture else None,
        "last_metrics_finite": bool(out["metrics"]) and all(math.isfinite(v) for v in out["metrics"].values()),
    }
    report["dreamer_v3"] = row
    print("phase 20(a) dreamer_v3_cartpole_pixels " + json.dumps(row), flush=True)
    if (
        out["env_steps"] != PIXEL_CUTS["algo.total_steps"]
        or out["gradient_steps"] <= 0
        or launches <= 0
        or bf16_launches != launches
        or capture is None
        or capture["windows"] != [PROFILE_WINDOW]
        or row["trace_gru_step_kernels"] <= 0
        or row["profile_failed_starts"]
        or not row["last_metrics_finite"]
    ):
        raise AssertionError(f"20(a) exp=dreamer_v3 on CartPole-v1 pixels: {row}")
    part_took("20a")

    # (b) cli_registration of (a)'s last checkpoint
    ckpt = max(glob.glob(f"{out['log_dir']}/checkpoint/*.ckpt"), key=lambda p: int(p.rsplit("ckpt_", 1)[1].split("_")[0]))
    registry = f"{tmp}/models_registry"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.registration([f"checkpoint_path={ckpt}", f"model_manager.registry_dir={registry}"])
    with open(f"{registry}/registry.json") as f:
        index = json.load(f)
    state = load_checkpoint(ckpt)
    models = ("world_model", "actor", "critic", "target_critic", "moments")
    exp_name = "dreamer_v3_CartPole-v1"
    equal = {}
    for m in models:
        (rec,) = index[f"{exp_name}_{m}"]
        with open(rec["artifact"], "rb") as f:
            equal[m] = tree_equal(np, pickle.load(f), state[m])
    report["registration"] = {"checkpoint": ckpt.rsplit("/", 1)[-1], "models": sorted(index), "artifacts_equal": equal}
    print("phase 20(b) registration " + json.dumps(report["registration"]), flush=True)
    if sorted(index) != sorted(f"{exp_name}_{m}" for m in models) or not all(equal.values()):
        raise AssertionError(f"20(b) cli_registration: {report['registration']}")
    part_took("20b")

    # (c) exp=sac_ae as composed: Pendulum-v1 pixels, frame stack 3
    args = ["exp=sac_ae", *[f"{k}={v}" for k, v in SAC_AE_PIXEL_CUTS.items()]]
    fg.reset_launch_count()
    out, fallbacks, seconds = ppo_cli(torch, tmp, "sac_ae_pixels", args, sac_ae)
    row = sac_run_report(out, seconds)
    row.update(fused_gru_launches=fg.launch_count, fused_fallback=fallbacks)
    report["sac_ae"] = row
    print("phase 20(c) sac_ae_pendulum_pixels " + json.dumps(row), flush=True)
    if out["env_steps"] != SAC_AE_PIXEL_CUTS["algo.total_steps"] or fg.launch_count != 0 or not all(map(math.isfinite, out["metrics"].values())):
        raise AssertionError(f"20(c) exp=sac_ae on Pendulum-v1 pixels: {row}")
    part_took("20c")

    # (d) the whole-run trace around a short exp=ppo
    trace_dir = f"{tmp}/whole_run_profile"
    steps = PPO_PROFILED_ROLLOUT * 4 * PPO_PROFILED_UPDATES
    args = ["exp=ppo", "env.backend=sync", f"algo.rollout_steps={PPO_PROFILED_ROLLOUT}", f"algo.total_steps={steps}", "metric.profiler.enabled=True", f"metric.profiler.trace_dir={trace_dir}"]
    out, _, seconds = ppo_cli(torch, tmp, "ppo_profiled", args, ppo)
    kernels = trace_kernels(f"{trace_dir}/trace.json")
    report["whole_run_trace"] = {
        "updates": out["updates"],
        "run_seconds": seconds,
        "trace_bytes": os.path.getsize(f"{trace_dir}/trace.json"),
        "trace_kernel_events": len(kernels),
        "distinct_kernels": len(set(kernels)),
    }
    print("phase 20(d) whole_run_trace " + json.dumps(report["whole_run_trace"]), flush=True)
    if out["updates"] != PPO_PROFILED_UPDATES or not kernels:
        raise AssertionError(f"20(d) metric.profiler around exp=ppo: {report['whole_run_trace']}")
    part_took("20d")

    # (e) cli_agents
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.available_agents()
    lines = buf.getvalue().splitlines()
    report["cli_agents"] = len(lines)
    if len(lines) != REGISTERED_ALGORITHMS or not all(line.startswith("sheeprl_tpu_torch.algos.") for line in lines):
        raise AssertionError(f"20(e) cli_agents printed {lines}")

    # (f) host ms a rendered and resized frame; whether this machine has
    # dm_control and mujoco (the DMC adapter's packages), without importing them
    report["host_ms_per_frame"] = {exp: frame_ms(np, exp) for exp in ("dreamer_v3", "sac_ae")}
    report["dm_control_and_mujoco_installed"] = all(importlib.util.find_spec(m) is not None for m in ("dm_control", "mujoco"))
    print("phase 20(ef) " + json.dumps({k: report[k] for k in ("cli_agents", "host_ms_per_frame", "dm_control_and_mujoco_installed")}), flush=True)
    return report


# phase 21: Acrobot-v1 and MountainCarContinuous-v0 under exp=dreamer_v3,
# exp=ppo on MountainCar-v0 and Acrobot-v1 (SGD), the poll probe, DMC
# learning starts once each of the 4 envs holds a 64-step window, as in 20(a)
ACROBOT_CUTS = {"algo.total_steps": 272, "algo.learning_starts": 256, "buffer.size": 4096}
CLASSIC_PPO_MODELS = {
    "mlp_mountain_car": (["exp=ppo", "env.id=MountainCar-v0"], {"state": ((2,), "float32")}, 3),
    "mlp_acrobot_sgd": (["exp=ppo", "env.id=Acrobot-v1", "optim=sgd", "~algo.optimizer.eps"], {"state": ((6,), "float32")}, 3),
}
GATHER_CHECK = {"size": 512, "batch": 16, "sequence_length": 64, "timed": 20}


def native_gather_check(np, env_id: str) -> dict:
    """One batch of a host ``SequentialReplayBuffer`` holding ``env_id``'s
    64 x 64 frames (``exp=dreamer_v3``'s pipeline) at the replay's shape
    (batch 16 of 64 steps), gathered by the native kernel and, from the
    same seeded draws, by numpy: bit-equal; host ms a batch by each."""
    from unittest import mock

    from sheeprl_tpu_torch import native
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.data.buffers import SequentialReplayBuffer
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.utils.utils import dotdict

    env = make_env(dotdict(compose("config", ["exp=dreamer_v3", f"env.id={env_id}", "env.capture_video=False"])), SEED)()
    obs, _ = env.reset(seed=SEED)
    env.action_space.seed(SEED)
    frames = []
    for _ in range(GATHER_CHECK["size"]):
        frames.append(obs["rgb"])
        obs, _, terminated, truncated, _ = env.step(env.action_space.sample())
        if terminated or truncated:
            obs, _ = env.reset()
    env.close()
    batches, ms = [], []
    for kernel in (True, False):
        rb = SequentialReplayBuffer(GATHER_CHECK["size"], n_envs=1, obs_keys=("rgb",), seed=SEED)
        rb.add({"rgb": np.stack(frames)[:, None]})
        before = native.launch_count
        with contextlib.ExitStack() as stack:
            if not kernel:
                stack.enter_context(mock.patch.object(native, "gather_sequences", lambda *a, **k: None))
            batches.append(rb.sample(GATHER_CHECK["batch"], sequence_length=GATHER_CHECK["sequence_length"])["rgb"])
            # host ms a batch, the same draws' shapes, after the first
            t0 = time.perf_counter()
            for _ in range(GATHER_CHECK["timed"]):
                rb.sample(GATHER_CHECK["batch"], sequence_length=GATHER_CHECK["sequence_length"])
            ms.append((time.perf_counter() - t0) / GATHER_CHECK["timed"] * 1e3)
        if (native.launch_count > before) is not kernel:
            raise AssertionError(f"21(a) the native gather ran {native.launch_count - before} times, want {int(kernel)}")
    return {
        "shape": list(batches[0].shape),
        "bit_equal_to_numpy": bool(np.array_equal(*batches)),
        "bytes": int(batches[0].nbytes),
        "host_ms_per_batch_native": ms[0],
        "host_ms_per_batch_numpy": ms[1],
    }


def phase_more_classic(torch, np, fg, tmp: str, part_took) -> dict:
    """Phase 21 (the module docstring's item 21): (a) to (e)."""
    import importlib.util

    from sheeprl_tpu_torch import native
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.ppo import ppo

    report = {"card": card_line(), "cuts": {"MountainCarContinuous-v0": PIXEL_CUTS, "Acrobot-v1": ACROBOT_CUTS}}
    common = {"seed": SEED, "env.capture_video": False, "log_base_dir": f"{tmp}/logs", "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl"}
    launches = 0

    # (a), (b) exp=dreamer_v3 on the new ids' frames, (a) on the host buffer
    for part, env_id, cuts, extra in (
        ("21(a)", "MountainCarContinuous-v0", PIXEL_CUTS, {"buffer.device": False}),
        ("21(b)", "Acrobot-v1", ACROBOT_CUTS, {}),
    ):
        # no test episode: MountainCarContinuous-v0's lasts its 999 steps
        # (20(a) plays the flagship's)
        extra = {**extra, "algo.run_test": False}
        argv = ["exp=dreamer_v3", f"env.id={env_id}", f"run_name=dv3_{env_id}"]
        argv += [f"{k}={v}" for k, v in {**cuts, **extra, **common}.items()]
        gathers = native.launch_count
        out, calls, bf16_calls, seconds = cli_in_process(torch, fg, argv, dv3)
        n = main_path_launches(out, calls)
        captured = out["captured_launches_per_step"]
        row = {
            "env_steps": out["env_steps"],
            "gradient_steps": out["gradient_steps"],
            "replays": out["replays"],
            "replay_buffer": out["replay_buffer"],
            "env_steps_per_s": out["env_steps"] / out["seconds"],
            "run_seconds": seconds,
            "fused_gru_wrapper_calls": calls,
            "fused_gru_launches": n,
            "fused_gru_bf16_x_launches": bf16_calls - captured + captured * out["replays"],
            "native_gathers": native.launch_count - gathers,
            "last_metrics_finite": bool(out["metrics"]) and all(math.isfinite(v) for v in out["metrics"].values()),
        }
        launches += n
        report[env_id] = row
        print(f"phase {part} dreamer_v3_{env_id} " + json.dumps(row), flush=True)
        if (
            out["env_steps"] != cuts["algo.total_steps"]
            or out["gradient_steps"] <= 0
            or n <= 0
            or row["fused_gru_bf16_x_launches"] != n
            or not row["last_metrics_finite"]
            # the host buffer, memmapped as exp=dreamer_v3 composes it
            or ("buffer.device" in extra and (out["replay_buffer"] not in ("host", "memmap") or row["native_gathers"] <= 0))
        ):
            raise AssertionError(f"{part} exp=dreamer_v3 on {env_id} frames: {row}")
        part_took(part[-2])
    report["host_ms_per_frame"] = {env_id: frame_ms(np, "dreamer_v3", env_id) for env_id in ("MountainCarContinuous-v0", "Acrobot-v1")}
    report["native_gather"] = native_gather_check(np, "MountainCarContinuous-v0")
    print("phase 21(a) frames_and_gather " + json.dumps({k: report[k] for k in ("host_ms_per_frame", "native_gather")}), flush=True)
    if not report["native_gather"]["bit_equal_to_numpy"]:
        raise AssertionError(f"21(a) the native gather against numpy: {report['native_gather']}")

    # (c) exp=ppo on MountainCar-v0 and Acrobot-v1 (SGD): each update
    # captured against eager, then 2 updates through the CLI; (d) the
    # MountainCar run polls the card with the link probe
    fg.reset_launch_count()
    report["ppo"] = {}
    with cudnn_deterministic(torch):
        for model, (exp, _, _) in CLASSIC_PPO_MODELS.items():
            row = captured_against_eager(torch, lambda model=model: ppo_update_models(torch, np, model), f"21(c) {model}")
            row["optimizer"] = ppo_cfg(*exp).algo.optimizer["_target_"].rsplit(".", 1)[-1]
            report["ppo"][model] = {"update": row}
    if [r["update"]["optimizer"] for r in report["ppo"].values()] != ["adam", "sgd"]:
        raise AssertionError(f"21(c) the optimizers: {report['ppo']}")
    for model, (exp, _, _) in CLASSIC_PPO_MODELS.items():
        args = [*exp, "env.backend=sync", "metric.log_level=1", f"algo.total_steps={128 * 4 * PPO_PROFILED_UPDATES}"]
        if model == "mlp_mountain_car":
            args += ["metric.telemetry.enabled=True", "metric.telemetry.poll_rtt=True", "metric.telemetry.poll_interval=0"]
        out, fallbacks, seconds = ppo_cli(torch, tmp, f"ppo_{model}", args, ppo)
        row = ppo_run_report(out, seconds)
        report["ppo"][model]["cli"] = row
        if out["updates"] != PPO_PROFILED_UPDATES or fallbacks or not all(map(math.isfinite, out["metrics"].values())):
            raise AssertionError(f"21(c) exp=ppo {model}: {row} {fallbacks}")
        if model == "mlp_mountain_car":
            record = [json.loads(line) for line in open(f"{tmp}/RUNS.jsonl")][-1]
            polls = [e for e in map(json.loads, open(record["telemetry_jsonl"])) if e.get("event") == "device_poll"]
            report["poll_rtt"] = {"device_polls": len(polls), "rtt_ms": [p.get("rtt_ms") for p in polls]}
    print("phase 21(cd) " + json.dumps({"ppo": report["ppo"], "poll_rtt": report["poll_rtt"]}), flush=True)
    if fg.launch_count or not report["poll_rtt"]["device_polls"] or not all(r is not None and r > 0 for r in report["poll_rtt"]["rtt_ms"]):
        raise AssertionError(f"21(cd) B1 launches {fg.launch_count} (want 0); polls {report['poll_rtt']}")
    part_took("21cd")

    # (e) the DMC adapter: whether dm_control is here; where it is absent,
    # building the walker exp's env raises naming it
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs.factory import make_env
    from sheeprl_tpu_torch.utils.utils import dotdict

    installed = importlib.util.find_spec("dm_control") is not None
    report["dmc"] = {"dm_control_installed": installed}
    if not installed:
        cfg = dotdict(compose("config", ["exp=dreamer_v3_dmc_walker_walk", "env.capture_video=False"]))
        try:
            make_env(cfg, SEED)()
        except ModuleNotFoundError as err:
            report["dmc"]["raised"] = {"type": type(err).__name__, "name": err.name, "message": str(err)[:120]}
        if report["dmc"].get("raised", {}).get("name") != "dm_control":
            raise AssertionError(f"21(e) the walker exp's env without dm_control: {report['dmc']}")
    print("phase 21(e) " + json.dumps(report["dmc"]), flush=True)
    report["fused_gru_launches"] = launches
    return report


def phase_capture_window(torch, np, fg, tmp: str) -> dict:
    """A probe beside phase 20, not run by ``main``: ``exp=dreamer_v3`` as
    in 20(a), 272 env steps, with the triggered window the first train
    window (64), which captures the step as a CUDA graph under the
    profiler. Reports the window's start-to-trace seconds and kernel
    events, the graph's replays and the last metrics; fails if the capture
    or a replay fails or a metric is not finite. Alone on the card, from a
    file with a ``__main__`` guard: ``fg.load_library();
    c.phase_capture_window(torch, np, fg, tempfile.mkdtemp())``."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3

    cuts = {**PIXEL_CUTS, "algo.total_steps": 272, "algo.run_test": False}
    argv = ["exp=dreamer_v3", "run_name=capture_window", "metric.telemetry.enabled=True", "metric.telemetry.profile_windows=[64]"]
    argv += [f"{k}={v}" for k, v in {**cuts, "seed": SEED, "env.capture_video": False, "log_base_dir": f"{tmp}/logs", "metric.telemetry.runs_jsonl": f"{tmp}/RUNS.jsonl"}.items()]
    out, calls, _, seconds = cli_in_process(torch, fg, argv, dv3)
    record = [json.loads(line) for line in open(f"{tmp}/RUNS.jsonl")][-1]
    (capture,) = record["profile_captures"]
    kernels = trace_kernels(f"{capture['trace_dir']}/trace.json")
    row = {
        "card": card_line(),
        "window": capture["windows"],
        "capture_wall_s": capture["t_end"] - capture["t_start"],
        "trace_kernel_events": len(kernels),
        "trace_gru_step_kernels": sum("gru_step" in k for k in kernels),
        "graphs": out["graphs"],
        "gradient_steps": out["gradient_steps"],
        "run_seconds": seconds,
        "fused_gru_launches": main_path_launches(out, calls),
        "last_metrics_finite": bool(out["metrics"]) and all(math.isfinite(v) for v in out["metrics"].values()),
    }
    print("capture_window " + json.dumps(row), flush=True)
    if not row["last_metrics_finite"] or out["replays"] != out["gradient_steps"] or not row["trace_gru_step_kernels"]:
        raise AssertionError(f"a triggered window across the step's capture: {row}")
    return row


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    try:
        from sheeprl_tpu_torch.ops import _build
        from sheeprl_tpu_torch.ops import fused_gru as fg
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False")

    t_smoke = t_phase = time.perf_counter()

    t_part = t_smoke

    def phase_took(name: str) -> None:
        nonlocal t_phase, t_part
        now = time.perf_counter()
        print(f"phase {name} took {now - t_phase:.1f} s (smoke {now - t_smoke:.1f} s)", flush=True)
        t_phase = t_part = now

    def part_took(name: str) -> None:
        # a phase's parts, so that a slow host's time can be placed
        nonlocal t_part
        now = time.perf_counter()
        print(f"part {name} took {now - t_part:.1f} s", flush=True)
        t_part = now

    # phase 1: card and build
    print(card_line(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    fg.load_library()
    print(f"build: {fg.KERNEL} in {time.perf_counter() - t0:.2f} s", flush=True)
    print(_build.PTXAS_REPORT[fg.KERNEL], flush=True)
    phase_took("1")

    # phase 2: kernel against plain (S: X = 32*32 + 3 actions)
    shapes = {
        "S_B1": (1, 1027, 512, 512),
        "S_B4": (4, 1027, 512, 512),
        "S_B16": (16, 1027, 512, 512),
        "M_B4": (4, 1027, 640, 1024),
        "S_B1024": (1024, 1027, 512, 512),
    }
    max_err, rows = phase_kernel(torch, fg, shapes)
    phase_took("2")

    # phase 3: the slice
    launches = phase_slice(torch, np, fg)
    phase_took("3")

    # phase 4: the model-sharded step, (a) its projection kernel, (b) the step
    bf16 = torch.bfloat16
    proj_shapes = {  # (B, H, D, C = 3H/mp, W2s storage)
        "S_mp1_fp32_B4": (4, 512, 512, 1536, torch.float32),
        "S_mp1_fp32_B16": (16, 512, 512, 1536, torch.float32),
        "XL_mp1_bf16_B16": (16, 4096, 1024, 12288, bf16),
        "L_mp4_bf16_B16": (16, 2048, 768, 1536, bf16),
        "L_mp4_bf16_B64": (64, 2048, 768, 1536, bf16),
        "L_mp4_bf16_B256": (256, 2048, 768, 1536, bf16),
        "L_mp4_bf16_B1024": (1024, 2048, 768, 1536, bf16),
        "XL_mp16_bf16_B16": (16, 4096, 1024, 768, bf16),
        "XL_mp16_bf16_B1024": (1024, 4096, 1024, 768, bf16),
    }
    proj_err, proj_rows = phase_proj(torch, fg, proj_shapes)
    part_took("4a")
    proj_launches = phase_sharded_step(torch, np, fg)
    phase_took("4")

    # phase 6: training, (a) fused against plain and (b) launches a step,
    # (c) time an eager step, (d) the short loop (replayed steps)
    step_launches, rb, obs_space, actions_dim, is_continuous = phase_train_parity(torch, np, fg)
    part_took("6a")
    timing = phase_train_timing(torch, np, fg, rb, obs_space, actions_dim, is_continuous)
    part_took("6c")
    with tempfile.TemporaryDirectory() as tmp:
        loop_launches, loop = phase_train_loop(torch, np, fg, tmp)
    phase_took("6")

    # phase 7: the captured step, (a) replayed against eager, (b) fresh
    # noise, (c) time a replayed step, (d) rollback and resume on main()
    phase_replay_parity(torch, np, rb, obs_space, actions_dim, is_continuous)
    part_took("7a")
    replay = phase_replay_timing(torch, rb, obs_space, actions_dim, is_continuous)
    part_took("7c")
    with tempfile.TemporaryDirectory() as tmp:
        phase_drill(torch, np, tmp)
    phase_took("7")

    # phase 8: the default precision, bf16-mixed: (a) B1 with a bf16 x, (b)
    # the eager step against plain and fp32, (c) replayed against eager, (d)
    # ms a replayed step with a profile, (e) the short loop, (f) the player
    bf16_err, bf16_rows = phase_bf16_kernel(torch, fg, BF16_KERNEL_SHAPES)
    part_took("8a")
    phase_bf16_train(torch, np, fg, rb, obs_space, actions_dim, is_continuous)
    print("bf16_replay_parity " + json.dumps(replay_against_eager(torch, np, rb, obs_space, actions_dim, is_continuous, BF16)), flush=True)
    bf16_timing = phase_bf16_timing(torch, rb, obs_space, actions_dim, is_continuous)
    part_took("8bcd")
    with tempfile.TemporaryDirectory() as tmp:
        bf16_loop_launches, bf16_loop = phase_train_loop(torch, np, fg, tmp, BF16, "bf16_train_loop")
        part_took("8e")
    bf16_player_launches, bf16_player = phase_bf16_player(torch, np, fg)
    phase_took("8")

    # phase 9: replay where the JAX package keeps it (bf16-mixed): (a) the
    # ring on the card, (b) a superstep against single replays, (c) the four
    # replay paths timed, (d) main() three ways and the drill across modes
    phase_ring(torch, np)
    part_took("9a")
    superstep = phase_superstep_parity(torch, np, rb, obs_space, actions_dim, is_continuous)
    part_took("9b")
    paths = phase_replay_paths(torch, np, rb, obs_space, actions_dim, is_continuous)
    part_took("9c")
    with tempfile.TemporaryDirectory() as tmp:
        ring_loop_launches, ring_loops = phase_ring_loops(torch, np, fg, tmp)
        part_took("9d_loops")
        phase_ring_drill(torch, np, tmp)
    phase_took("9")

    # phase 10: the entry point, (a) train through the CLI, (b) cli_eval,
    # (c) resume with a precision override, (d) times
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, cli = phase_cli(torch, np, fg, tmp, bf16_loop)
    phase_took("10")

    # phase 11: the env pipeline, (a) the pixel specs on the card and
    # ImageTransform, (b) PixelPendulum through the CLI (action repeat 2,
    # async), (c) the grayscale/resize path and the restart drill on the ring
    with tempfile.TemporaryDirectory() as tmp:
        env_launches, env_report = phase_env_pipeline(torch, np, fg, tmp)
    phase_took("11")

    # phase 12: PPO, (a) the captured update against eager, (b) exp=ppo
    # on the host loop, (c) the fused rollout at 4 and 64 envs, (d) NatureCNN
    # on PixelCatcher; (e) Dreamer-V3 S at bf16-true against bf16-mixed
    ppo_update = phase_ppo_update(torch, np)
    part_took("12a")
    # phase 15 serves these runs' checkpoints: the directory lives until then
    ppo_tmp = tempfile.TemporaryDirectory()
    ppo_runs = phase_ppo_cli(torch, ppo_tmp.name)
    part_took("12bcd")
    bf16_true_launches = phase_bf16_true(torch, np, fg, rb, obs_space, actions_dim, is_continuous)
    phase_took("12")

    # phase 13: A2C, (a) the captured update against eager, (b) exp=a2c on
    # the host loop and fused; recurrent PPO, (c) both updates captured
    # against eager and the player's LSTM step against the CPU, (d)
    # exp=ppo_recurrent on the host loop and fused. Neither reaches B1 or B2
    b1_before, b2_before = fg.launch_count, fg.proj_launch_count
    a2c_update = phase_a2c_update(torch, np)
    part_took("13a")
    with tempfile.TemporaryDirectory() as tmp:
        a2c_runs = phase_a2c_cli(torch, tmp)
        part_took("13b")
    rppo_update = phase_rppo_update(torch, np)
    part_took("13c")
    with tempfile.TemporaryDirectory() as tmp:
        rppo_runs = phase_rppo_cli(torch, tmp)
    if (fg.launch_count, fg.proj_launch_count) != (b1_before, b2_before):
        raise AssertionError(f"phase 13 launched B1 {fg.launch_count - b1_before} and B2 {fg.proj_launch_count - b2_before} times, want 0")
    phase_took("13")

    # phase 14: SAC, DroQ and SAC-AE, (a) each update captured against
    # eager at full width, (b) the CLI runs on the ring and the host buffer
    # (SAC fused too), (c) cli_eval; (d) neither B1 nor B2 launched
    b1_before, b2_before = fg.launch_count, fg.proj_launch_count
    sac_update = phase_sac_update(torch, np)
    part_took("14a")
    with tempfile.TemporaryDirectory() as tmp:
        sac_runs = phase_sac_cli(torch, np, tmp)
    if (fg.launch_count, fg.proj_launch_count) != (b1_before, b2_before):
        raise AssertionError(f"phase 14 launched B1 {fg.launch_count - b1_before} and B2 {fg.proj_launch_count - b2_before} times, want 0")
    print("phase 14(d) b1_b2_launches 0", flush=True)
    phase_took("14")

    # phase 15: the serving tier over phase 12's PPO checkpoints, (a) the
    # ladder of CUDA graphs (MLP and NatureCNN), (b) the CLI's load runs,
    # (c) the drills; neither B1 nor B2 launched
    serve = phase_serve(torch, np, fg, ppo_tmp.name)
    phase_took("15")

    # phase 16: Plan2Explore on Dreamer-V3 at S, bf16-mixed, (a) the
    # exploration step replayed against eager and B1 against plain, its
    # time and profile, (b) exploration and finetuning through the CLI,
    # then cli_eval
    p2e_step = phase_p2e_step(torch, np, fg, rb, obs_space, actions_dim, is_continuous)
    part_took("16a")
    with tempfile.TemporaryDirectory() as tmp:
        p2e_launches, p2e_bf16_launches, p2e_cli = phase_p2e_cli(torch, np, fg, tmp)
    phase_took("16")

    # phase 17: (a) the placement probe and runs with the player or the
    # update on the host, (b) PPO's overlapped collection, (c) Dreamer-V2:
    # its step replayed against eager and timed, exp=dreamer_v2 with each
    # buffer type through the CLI, then cli_eval
    with tempfile.TemporaryDirectory() as tmp:
        placement_launches, placement = phase_placement(torch, np, fg, tmp)
        part_took("17a")
    overlap = phase_overlap(torch, np)
    part_took("17b")
    dv2_step = phase_dv2_step(torch, np, fg, rb, obs_space, actions_dim, is_continuous)
    part_took("17c_step")
    with tempfile.TemporaryDirectory() as tmp:
        dv2_cli = phase_dv2_cli(torch, np, fg, tmp)
    phase_took("17")

    # phase 18: (a) the Dreamer-V1 step and (b) the P2E-DV2 and P2E-DV1
    # exploration steps, each replayed against eager, timed and profiled;
    # (c) exp=dreamer_v1 and both P2E explorations and finetunings through
    # the CLI, then cli_eval of each. None launches B1 or B2 (checked)
    family_steps = {exp: phase_family_step(torch, np, fg, rb, obs_space, actions_dim, is_continuous, exp) for exp in FAMILY_STEPS}
    part_took("18ab")
    with tempfile.TemporaryDirectory() as tmp:
        family_cli = phase_family_cli(torch, np, fg, tmp)
    phase_took("18")

    # phase 19: the replica fleet over phase 12's exp=ppo MLP checkpoint,
    # (a) every slot's rungs, (b) the CLI's closed loop and ramp, (c) the
    # drills; neither B1 nor B2 launched
    with ppo_tmp:
        fleet = phase_fleet(torch, np, fg, ppo_tmp.name, serve, part_took)
    phase_took("19")

    # phase 20: exp=dreamer_v3 and exp=sac_ae as composed (the classic-control
    # frames), the triggered and whole-run profilers, cli_registration and
    # cli_agents, the host's ms a frame
    with tempfile.TemporaryDirectory() as tmp:
        defaults = phase_default_configs(torch, np, fg, tmp, part_took)
    pixel_launches = defaults["dreamer_v3"]["fused_gru_launches"]
    phase_took("20")

    # phase 21: exp=dreamer_v3 on MountainCarContinuous-v0 (host buffer,
    # native gather) and Acrobot-v1 frames, exp=ppo on MountainCar-v0 and
    # Acrobot-v1 (SGD), the poll probe, the DMC adapter's check
    with tempfile.TemporaryDirectory() as tmp:
        more = phase_more_classic(torch, np, fg, tmp, part_took)
    more_launches = more["fused_gru_launches"]
    phase_took("21")

    # phase 5: the kernels line, then the device line
    main_row = next(r for r in rows if r["shape"] == "S_B4")
    big_row = next(r for r in rows if r["shape"] == "S_B1024")
    proj_row = next(r for r in proj_rows if r["shape"] == "L_mp4_bf16_B16")
    kernels = [
        {
            "name": "fused_gru",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/fused_gru.cu",
            "replaces": "sheeprl_tpu/ops/pallas_gru.py:178",
            "launches": launches + loop_launches + bf16_loop_launches + bf16_player_launches + sum(ring_loop_launches.values()) + cli_launches + sum(env_launches.values()) + bf16_true_launches + sum(p2e_launches.values()) + placement_launches + pixel_launches + more_launches,
            # every launch of the bf16-mixed and bf16-true paths read a bf16 x
            # (checked there; P2E's counted in its runs)
            "launches_bf16_x": bf16_loop_launches + bf16_player_launches + sum(ring_loop_launches.values()) + cli_launches + sum(env_launches.values()) + bf16_true_launches + sum(p2e_bf16_launches.values()) + placement["dreamer_v3_player_cpu"]["fused_gru_bf16_x_launches"] + defaults["dreamer_v3"]["fused_gru_bf16_x_launches"] + sum(more[e]["fused_gru_bf16_x_launches"] for e in ("MountainCarContinuous-v0", "Acrobot-v1")),
            "launches_by_path": {
                "player_and_evaluate": launches,
                "train_loop": loop_launches,
                "train_loop_replays": loop["replays"],
                "bf16_train_loop": bf16_loop_launches,
                "bf16_train_loop_replays": bf16_loop["replays"],
                "bf16_player": bf16_player_launches,
                "bf16_ring_train_loops": ring_loop_launches,
                "cli_train_loop": cli_launches,
                "cli_train_loop_replays": cli["replays"],
                "env_pipeline_cli_loops": env_launches,
                "dv3_bf16_true_and_mixed_steps": bf16_true_launches,
                "p2e_dv3": p2e_launches,
                "dv3_player_on_host": placement_launches,
                "dreamer_v3_cartpole_pixels_cli": pixel_launches,
                "dreamer_v3_mountain_car_continuous_and_acrobot_pixels_cli": {e: more[e]["fused_gru_launches"] for e in ("MountainCarContinuous-v0", "Acrobot-v1")},
                "per_gradient_step": step_launches,
                "per_superstep_replay_by_profiler": superstep["profile"]["gru_step_kernels_per_replay"] / 2,
                "per_replayed_step_by_profiler": replay["profile_fused"]["gru_step_kernels_per_replay"] / 2,
            },
            "max_abs_err": max_err,
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            # no single PyTorch call computes the fused step
            "library_ms": None,
            "B1024": {k: big_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "ms_per_gradient_step_eager": min(timing["ms_per_gradient_step_fused"]),
            "ms_per_gradient_step_replayed": min(replay["ms_per_gradient_step_fused_replayed"]),
            "train_loop_env_steps_per_s": loop["env_steps_per_s"],
            "bf16_x": {
                "max_abs_err": bf16_err,
                **{r["shape"]: {k: r[k] for k in ("ms", "fp32_x_ms", "plain_ms", "bound_ms", "bound_by")} for r in bf16_rows},
                "ms_per_replayed_step": min(bf16_timing["ms_per_replayed_step_b1_bf16"]),
                "train_loop_env_steps_per_s": bf16_loop["env_steps_per_s"],
                "player_env_steps_per_s": bf16_player["env_steps_per_s"],
                "ms_per_gradient_step_by_replay_path": {k: min(v["ms_per_gradient_step"]) for k, v in paths["paths"].items() if k in PATHS},
                "ring_train_loop_env_steps_per_s": {k: [r["env_steps_per_s"] for r in ring_loops[k]] for k in RING_LOOPS},
                "cli_env_steps_per_s": cli["env_steps_per_s"],
                "cli_mfu": cli["mfu_last_heartbeat"],
                "pixel_pendulum_async_env_steps_per_s": env_report["pendulum"]["env_steps_per_s"],
                "host_ms_per_vector_step": env_report["host_ms_per_vector_step"],
            },
            # PPO (phase 12) reaches no TPU kernel: its numbers ride here
            "ppo": {
                "ms_per_update_replayed": {m: ppo_update[m]["ms_per_update_replayed"] for m in PPO_MODELS},
                "host_loop_env_steps_per_s": ppo_runs["host_loop"]["env_steps_per_s"],
                "host_loop_env_steps_per_s_steady": ppo_runs["host_loop"]["env_steps_per_s_steady"],
                "fused_env_steps_per_s": {envs: r["env_steps_per_s"] for envs, r in ppo_runs["fused"].items()},
                "fused_env_steps_per_s_steady": {envs: r["env_steps_per_s_steady"] for envs, r in ppo_runs["fused"].items()},
                "nature_cnn_env_steps_per_s": ppo_runs["nature_cnn"]["env_steps_per_s"],
            },
            # A2C and recurrent PPO (phase 13) reach no TPU kernel and launch
            # neither B1 nor B2 (checked): their numbers ride here too
            "a2c": {
                "b1_b2_launches": 0,
                "ms_per_update_replayed": a2c_update["a2c_cartpole"]["ms_per_update_replayed"],
                "host_loop_env_steps_per_s": a2c_runs["host_loop"]["env_steps_per_s"],
                "host_loop_env_steps_per_s_steady": a2c_runs["host_loop"]["env_steps_per_s_steady"],
                "fused_env_steps_per_s": a2c_runs["fused"]["env_steps_per_s"],
                "fused_env_steps_per_s_steady": a2c_runs["fused"]["env_steps_per_s_steady"],
            },
            "ppo_recurrent": {
                "b1_b2_launches": 0,
                "ms_per_update_replayed": {k: rppo_update[k]["ms_per_update_replayed"] for k in ("host_padded_chunks", "fused_fixed_windows")},
                "host_loop_env_steps_per_s": rppo_runs["host_loop"]["env_steps_per_s"],
                "host_loop_env_steps_per_s_steady": rppo_runs["host_loop"]["env_steps_per_s_steady"],
                "host_loop_captures": rppo_runs["host_loop"]["captures"],
                "fused_env_steps_per_s": rppo_runs["fused"]["env_steps_per_s"],
                "fused_env_steps_per_s_steady": rppo_runs["fused"]["env_steps_per_s_steady"],
            },
            # serving PPO (phase 15) reaches no TPU kernel and launches
            # neither B1 nor B2 (checked)
            "serve": {
                "b1_b2_launches": 0,
                "ms_per_replay": {m: {b: r["ms_per_replay"] for b, r in row["rungs"].items()} for m, row in serve["ladder"].items()},
                "host_ms_per_round_trip": {m: {b: r["host_ms_per_round_trip"] for b, r in row["rungs"].items()} for m, row in serve["ladder"].items()},
                "capture_s": {m: row["capture_s"] for m, row in serve["ladder"].items()},
                "host_ms_per_request_b1": {m: {k: row[k] for k in ("host_ms_per_request_b1_window_0", "host_ms_per_request_b1_window_default")} for m, row in serve["ladder"].items()},
                **{run: {k: serve["cli"][run][k] for k in ("qps", "p50_ms", "p95_ms", "slo_ms", "slo_met", "mean_batch", "shed", "client_retries")} for run in ("closed_loop", "open_loop")},
                "hot_swap": {k: serve["drills"]["hot_swap"][k] for k in ("slo_ms", "shed_expired", "failed", "latency_ms_max_across_swap", "request_swap_s", "swap_pause_s")},
            },
            # the replica fleet (phase 19) reaches no TPU kernel and launches
            # neither B1 nor B2 (checked)
            "serve_fleet": {
                "b1_b2_launches": 0,
                "closed_loop": {k: fleet["cli"]["closed_loop"][k] for k in ("qps", "p50_ms", "p95_ms", "slo_ms", "mean_batch", "hedged", "rerouted_requests", "shed_overloaded", "scan_lag_ms")},
                "single_server_closed_loop": {k: serve["cli"]["closed_loop"][k] for k in ("qps", "p50_ms", "p95_ms", "slo_ms", "mean_batch")},
                "ramp": {k: fleet["cli"]["ramp"][k] for k in ("offered_rates_hz", "knee_rate_hz", "max_good_qps", "hedged", "rerouted_requests", "shed_overloaded", "shed_expired", "scan_lag_ms")},
                "kill_mid_ramp": {k: fleet["drills"]["kill_mid_ramp"][k] for k in ("p95_ms", "slo_ms", "rerouted_requests", "hedged")},
                "standby_capture": fleet["drills"]["autoscale"]["slot_captures"],
                "cpu_spill_load": {k: fleet["drills"]["cpu_spill"][k] for k in ("load_qps", "load_p50_ms", "load_p95_ms")},
                "hot_swap": {k: fleet["drills"]["hot_swap"][k] for k in ("requests", "swap_capture_s", "swap_pause_s", "request_swap_s")},
            },
            # Plan2Explore on Dreamer-V3 (phase 16) runs B1 in its scan and
            # both imaginations of an exploration step
            "p2e_dv3": {
                "calls_per_exploration_step": p2e_step["replayed_vs_eager"]["captured_fused_gru_calls"],
                "gru_step_kernels_per_replay_by_profiler": p2e_step["profile"]["gru_step_kernels_per_replay"],
                "ms_per_exploration_replay": p2e_step["ms_per_replay"],
                "device_idle_share": p2e_step["profile"]["device_idle_share"],
                "b1_vs_plain_metric_max_rel_err": p2e_step["b1_vs_plain"]["metric_max_rel_err"],
                "env_steps_per_s": {name: r["env_steps_per_s"] for name, r in p2e_cli["runs"].items()},
                "finetuning_switched_to_task_actor_at": p2e_cli["runs"]["finetuning"]["player_switched_to_task_actor_at_policy_step"],
            },
            # phase 17: the placements (B1 launched by the learner only),
            # PPO's overlap and Dreamer-V2 (which reaches no TPU kernel)
            "placement": {
                "dispatch_roundtrip_seconds": placement["probe"]["dispatch_roundtrip_seconds"],
                "auto": {k: placement["probe"][k] for k in ("player_auto", "train_auto_ppo_mlp")},
                "ppo_env_steps_per_s": {k: r["env_steps_per_s"] for k, r in placement["ppo"].items()},
                "dv3_player_cpu_env_steps_per_s": placement["dreamer_v3_player_cpu"]["env_steps_per_s"],
                "dv3_player_cpu_b1_launches_by_player": placement["dreamer_v3_player_cpu"]["player_b1_launches"],
            },
            "ppo_overlap": {
                "env_steps_per_s": {k: overlap[k]["env_steps_per_s"] for k in ("no_overlap", "overlap")},
                "train_wait_share": {k: overlap[k]["train_wait_share"] for k in ("no_overlap", "overlap")},
                "updates_bit_equal_alone": all(overlap["updates_bit_equal_alone"]),
            },
            "dreamer_v2": {
                "b1_launches": 0,
                "ms_per_replay": dv2_step["ms_per_replay"],
                "device_idle_share": dv2_step["profile"]["device_idle_share"],
                "env_steps_per_s": {k: r["env_steps_per_s"] for k, r in dv2_cli["runs"].items()},
            },
            # phase 18: Dreamer-V1 and P2E over Dreamer-V2 and V1 reach no
            # TPU kernel and launch neither B1 nor B2 (checked)
            "dreamer_v1_p2e_dv1_dv2": {
                "b1_b2_launches": 0,
                "ms_per_replay": {k: r["ms_per_replay"] for k, r in family_steps.items()},
                "device_idle_share": {k: r["profile"]["device_idle_share"] for k, r in family_steps.items()},
                "env_steps_per_s": {k: r["env_steps_per_s"] for k, r in family_cli["runs"].items()},
                "env_steps_per_s_steady": {k: r["env_steps_per_s_steady"] for k, r in family_cli["runs"].items()},
            },
            # phase 21: the new classic-control ids, SGD, the poll probe,
            # the native gather and the DMC adapter's check
            "more_classic": {
                "dreamer_v3_env_steps_per_s": {e: more[e]["env_steps_per_s"] for e in ("MountainCarContinuous-v0", "Acrobot-v1")},
                "host_ms_per_frame": more["host_ms_per_frame"],
                "native_gathers_in_host_buffer_run": more["MountainCarContinuous-v0"]["native_gathers"],
                "native_gather": more["native_gather"],
                "ppo_ms_per_update_replayed": {m: r["update"]["ms_per_update_replayed"] for m, r in more["ppo"].items()},
                "ppo_env_steps_per_s": {m: r["cli"]["env_steps_per_s"] for m, r in more["ppo"].items()},
                "poll_rtt_ms": more["poll_rtt"]["rtt_ms"],
                "dm_control_installed": more["dmc"]["dm_control_installed"],
            },
            # phase 20: the default configs on the classic-control frames;
            # B1 runs in exp=dreamer_v3's loop, not in exp=sac_ae's
            "default_configs": {
                "dreamer_v3_env_steps_per_s": defaults["dreamer_v3"]["env_steps_per_s"],
                "sac_ae_env_steps_per_s": defaults["sac_ae"]["env_steps_per_s"],
                "host_ms_per_frame": defaults["host_ms_per_frame"],
                "triggered_trace_gru_step_kernels": defaults["dreamer_v3"]["trace_gru_step_kernels"],
                "traced_window_train_ms": defaults["dreamer_v3"]["traced_window_train_ms"],
                "untraced_window_train_ms_median": defaults["dreamer_v3"]["untraced_window_train_ms_median"],
                "whole_run_trace_kernel_events": defaults["whole_run_trace"]["trace_kernel_events"],
                "registered_models": len(defaults["registration"]["models"]),
            },
            # the SAC family (phase 14) reaches no TPU kernel and launches
            # neither B1 nor B2 (checked)
            "sac_family": {
                "b1_b2_launches": 0,
                "ms_per_replay": {n: {k: r["ms_per_replay"] for k, r in sac_update[n]["graphs"].items()} for n in SAC_MODELS},
                "sac_ae_flops_per_gradient_step": sac_update["sac_ae"]["flops_per_gradient_step"],
                "sac_ae_mfu_bf16": sac_update["sac_ae"]["mfu_bf16"],
                "env_steps_per_s": {run: r["env_steps_per_s"] for run, r in sac_runs["runs"].items()},
                "env_steps_per_s_steady": {run: r["env_steps_per_s_steady"] for run, r in sac_runs["runs"].items()},
            },
        },
        {
            "name": "sharded_proj",
            "route": "cuda",
            "source": "sheeprl_tpu_torch/csrc/fused_gru.cu",
            "replaces": "sheeprl_tpu/ops/pallas_gru.py:307",
            "launches": proj_launches,
            "max_abs_err": proj_err,
            "ms": proj_row["ms"],
            "plain_ms": proj_row["plain_ms"],
            "bound_ms": proj_row["bound_ms"],
            "bound_by": proj_row["bound_by"],
            "library_ms": proj_row["library_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = swap_drill_repeats(int(sys.argv[2])) if sys.argv[1:2] == ["--swap-drills"] else main()
    except Exception as e:  # any failed phase: report and exit non-zero, no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
