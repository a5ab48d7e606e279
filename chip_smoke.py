#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (handyrl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda), and exits
non-zero, printing no result, when either is missing or any phase fails.
To fit its time, the processes of phase 8 with 9(a)'s, the learner
processes of 9(b) with phase 10, of 11(a)-(c) with 11(d)'s export, of 12(c) and (d), of 13(a), of 13(b), of
14(b)/(c) and 14(f) (beside phase 13), of 16(a) and (b), and of phase 17 with 18(c) and (d)
run at once, phase 21's beside phases 11 and 12, and phase 19's fleet and
gateway (and the SWA tool) beside phases 16, 17 and 18 (each part still checks its own run; their rates,
16(a)'s MTTR and 19's latencies share the host and the card).

1. Prints the card (name and power limit from nvidia-smi), the torch and
   CUDA versions, and builds every CUDA kernel of the port from the
   checkout's sources (one nvcc per source, all started together). It
   counts the tensor-core instructions (HMMA) in the trunk kernels' SASS
   (``cuobjdump --dump-sass``), by instantiation, and fails unless K1's
   and K2b's are more than 0 in both forms (fp32 and bf16) at both widths.
   Every phase logs its seconds and the card.
2. Holds each kernel against its plain PyTorch version on the card, fp32
   with TF32 off, and times the kernel, the plain version and, where one
   PyTorch call computes the same function, that call:
   - K1, the trunk forward, at full GeeseNet width (Cin=17, F=32, L=12,
     8 groups) on real Hungry Geese observations, N in {1, 8, 16, 32, 64,
     100, 128, 256, 1024, 2048} (16-64: the host engine's ticks), its convs on the tensor cores in 3xTF32 (bounds
     over the TF32 peak), timed with CUDA events back to back (the kernels line's ms) and
     by torch.profiler's device time, which leaves the wrapper's host cost
     out (256 is the learners' generation bucket: 64 envs of four geese;
     128 the fused loop's evaluation ply, 32 envs of four geese; 1024 the
     fused loop's update step, B=64 x T=16);
     the library yardstick is the port's own ``torus_impl='pad'``
     trunk (cuDNN convs and torch's group_norm, which the kernel path never
     calls). At N in {8, 1024, 2048} also its training form, timed beside the
     serving form: the saved block inputs and normalised conv outputs
     (xhat, abs) and per-group rstd (relative) against the plain training
     forward's;
   - K2, the trunk backward, at the same width for N in {8, 64, 1024, 2048},
     from K1's training forward, every grad against the plain version's
     relative to the grad's largest element; the yardstick is torch
     autograd's backward through the 'pad' trunk. Its two phases (K2a,
     trunk_bwd_kernel; K2b, trunk_wgrad_kernel + column_sum, both on the
     tensor cores in 3xTF32) are timed apart by torch.profiler and each
     has its own bound. K2b also has its own plain version (the 13 plain
     weight grads from the same layer inputs and conv-output grads) and
     yardstick: cuDNN's weight grads of the 13 torus convs
     (``torch.nn.grad.conv2d_weight`` on circularly padded NCHW inputs,
     padded outside the timed region), timed by CUDA-graph replay;
   - K1 and K2 at the other width they are built for, F=16 (2 blocks,
     N=64), for correctness only, K1's saved tensors included;
   - K3-K5, the TD(lambda), UPGO and V-Trace recursions, at T in {1, 16},
     P in {1, 4} and N lanes (N = B*P) in {16, 64, 100, 128, 2048}, with
     one-row returns (the outcome, whose bootstrap row the kernels read in
     place): (T=16, P=1, N=128) is the headline step's and the row the
     kernels line reports, 16 the in-process steps', 64 the fused loop's
     (B=64, T=16, P=1), 100 a ragged edge; (T=16, P=2, N=256), the
     turn-based step's of phases 7 and 13(a) (B=128, two players); and
     (T=16, P=4, N=512), the recurrent host learner's of phase 13(b)
     (B=128, four geese);
     each timed by CUDA-graph replay (device time) and through its
     wrapper; no single PyTorch call computes a recursion, so they have no
     yardstick.
3. The main path, through the entry points a user calls: publishes a
   full-width GeeseNet(torus_impl='pallas') with seeded weights into a
   temporary registry, starts ``python -m handyrl_tpu_torch.serving`` on
   the card, plays Hungry Geese games (four geese, each ply's four requests
   coalesced into one batch) through ServiceClient, checks every reply, one
   served policy against a local 'pad' forward of the same weights, and
   the service's kernel launch counts: the service process starts with
   every count at 0, the script reads them just before the games (failing
   unless all are 0) and just after (failing unless each kernel of the
   path launched), then SIGTERMs the service and expects exit 75. The
   comparison launches of phase 2 run in this process and never count.
4. The training path, through its entry point: runs
   ``python -m handyrl_tpu_torch.bench --device cuda`` (the headline
   update step, B=128, T=16, full width, TD/TD, eager and as one CUDA
   graph; a fresh process whose counts start at 0 and are set to 0 again
   before its first step), reads its JSON line and fails unless the losses
   are finite, both forms were timed and K1, K2 and K3 launched once a
   step in each form. Then, in this process, for TD/TD and for
   UPGO/VTRACE (which must launch K4 and K5) at B=16 on real boards, with
   every count set to 0 just before each form: three eager steps and five
   graphed ones on the card; the first of each is held against the same
   step of the port on the CPU (same weights, same batch: loss terms, grad
   norm, params and Adam's first moment by leaf), the graphed steps
   against the eager ones step by step, and the graph's fourth step, with
   a NaN lr, must keep params, moments and count, report nonfinite 1 and
   advance steps, and its fifth must train. Last, torch.profiler over
   headline steps of each form (graph replays for the graphed one): the
   device busy time, the host-clock step and the idle share, and K1, K2a,
   K2b and K3 each once a step in the device rows, or it fails.
5. The local learner, through its entry point: writes the slice's JSON
   config (full-width GeeseNet, ``torus_impl='pallas'``, B=128, T=16,
   TD/TD, 64 generation envs, 256 episodes before the first epoch and
   512 an epoch (about 100 update steps an epoch at 256), LEARNER_EPOCHS
   epochs (2 since phase 16 came: 3 before), online
   evaluation against 'random') into a temporary directory and runs
   ``python -m handyrl_tpu_torch.train --config ... --device cuda`` (a
   fresh process, every count at 0). Fails unless it exits 0 having
   trained its epochs with finite losses, wrote every checkpoint with its CRC
   sidecar, changed the params between ``1.ckpt`` and the last one, and
   launched K1 in generation and evaluation (serving form) and K1, K2 and
   K3 in training once a step (the capture's eager warm-up steps
   included). Then loads ``latest.ckpt`` on the card and on the CPU and
   holds the card's forward to the CPU's on real boards (POLICY_TOL), and
   prints the learner's rates beside the bench's graphed step.
5(b). The same run with ``batcher_processes`` and ``batcher_shared_memory``
   and no --device: the batches are built by spawned processes into
   shared-memory slots. The same checks, and it fails unless the learner's
   JSON line says the shared-memory path was taken (batches mapped, slots
   used, its segments' names) and no segment of the run is in /dev/shm
   after the process exits (listings before and after). Prints both runs
   side by side: episodes/s, trajectories/s, update steps/s, the
   trainer's wait for batches and the loop's host seconds by stage.
6. The fused device loop, through the same entry point with no --device
   (the card is the default): the JAX package's north-star configuration
   (full-width GeeseNet, B=64, T=16, VTRACE/VTRACE, 64 generation envs,
   32-ply chunks, 32 eval envs, 64 SGD steps a chunk, 200 episodes before
   the first epoch and 100 an epoch, checkpoint files every 10 epochs,
   ``metrics_jsonl``), FUSED_EPOCHS epochs (60-120 s). Fails unless it
   exits 0 having run the fused pipeline in solo mode and closed every
   epoch, wrote the checkpoints of epochs 10, 20, ... and the last (and no
   other) with their CRC sidecars, wrote one metrics row an epoch with
   the run plane's keys (METRICS_KEYS in every row, each of
   METRICS_SOME_KEYS in some, steps monotonic), took steps = fused
   dispatches x 64, counted no retrace after warm-up, launched K1 under 'generation' and 'evaluation' (serving form) and K1,
   K2 and K5 under 'training' once a step (no warm-up steps: a graph's
   first call runs eagerly, as a real step), moved every leaf from
   ``10.ckpt`` to the last, and ``latest.ckpt``'s forward on the card
   matches the CPU's (POLICY_TOL). Then, in this process: the env twin's
   step, auto-reset, observation, greedy agent and outcome on the card
   against the CPU on the same state, actions and uniforms (equal
   exactly); the ingest of two chunks' card records with the same draws
   into a ring they wrap (equal exactly); three steps of the K-step update
   graph (eager, captured, replayed) against the CPU's step from the same
   state on the slots the card drew (phase 4's tolerances), and two
   replays drawing different slots; two replays of the rollout graph
   drawing different actions; one steady fused dispatch under
   torch.profiler (device busy time, idle share, top kernels, and K1, K2a,
   K2b and K5 as often as its graphs hold them). Prints the loop's rates
   beside phase 5's host learner, and its host seconds by stage, the
   epoch close split into the wait for the in-flight dispatch before a
   checkpoint and the checkpoint's copies and files.
7. The README's quick start, through both entry points with no --device:
   ``python -m handyrl_tpu_torch.train --config`` on ``tictactoe.json``
   (config.yaml's blocks: turn-based TicTacToe on the full-width
   SimpleConv2dModel, TD/TD, B=128, T=16, 64 envs, 400 episodes then 200
   an epoch), cut to QUICK_EPOCHS epochs. Fails unless every epoch ran
   with finite losses, every checkpoint passes ``verify_checkpoint``, the
   params moved from ``1.ckpt`` to the last, K3 launched once a step plus
   the capture's warm-ups under 'training' (at T=16, P=2, 256 lanes) and
   no other kernel anywhere, ``latest.ckpt``'s forward on the card matches
   the CPU's (POLICY_TOL), and tests/test_train_e2e.py's learning bar holds
   (at least 80 evaluation results over the last 5 epochs, a win rate
   above 0.6 against 'random'). Then ``python -m
   handyrl_tpu_torch.evaluation latest.ckpt 100 4`` must count all 100
   games for both agents in its report, played in 4 spawned processes.
   Prints the rates, the steps per epoch, K3's time at 256 lanes, the
   tournament's seconds and the main agent's win rate.
7(b). The quick start with ``batcher_processes`` and
   ``batcher_shared_memory``, cut to QUICK_SHM_EPOCHS epochs: phase 7's run
   checks (K3 at 256 lanes once a step, no other kernel, checkpoints that
   verify), the shared-memory path and /dev/shm as in 5(b), and its rates
   beside phase 7's.
7(c). The quick start on the fused device loop: ``tictactoe.json`` plus
   config.yaml's commented lines (``device_generation``,
   ``device_replay``, ``sgd_steps_per_chunk`` 16, ``checkpoint_interval``
   10), QUICK_FUSED_EPOCHS epochs, no --device. Fails unless the learner
   ran the fused pipeline in turn mode, every epoch closed with finite
   losses, steps = fused dispatches x 16, K3 launched once a step under
   'training' (T=16, P=2, 256 lanes) and no other kernel anywhere, the
   checkpoints of epochs 10 and 15 and ``latest.ckpt`` verify, its forward
   on the card matches the CPU's (POLICY_TOL) and phase 7's learning bar
   holds. Then, in this process: the TicTacToe twin's step, auto-reset,
   observation, legal mask, turn and outcome on the card against the CPU
   (equal exactly); the 'turn' ingest of two chunks' card records into a
   ring they wrap, card against CPU (equal exactly); three steps of the
   K-step update graph against the CPU's step from the same state on the
   same slots (phase 4's tolerances); a steady dispatch's chunk and step
   graphs timed by CUDA events. Prints its rates beside phase 7's.
8. Phase 6's run, read on. (a) ``scripts/torch_eval_checkpoints.py``
   scores its checkpoints of epoch 10 and of the last in a fresh process
   (counts from 0 at the first point): 512 games a point against
   'random', one evaluator and one captured rollout graph for both
   points. Fails unless K1 (serving form) launched under 'evaluation' and
   nothing else did, one rollout graph was captured, and the last point's
   win rate is at least 0.95 and not below epoch 10's. (b) A preemption
   drill: the learner resumes the model dir (``restart_epoch: -1``, 6
   more epochs, ``keep_checkpoints: 3``) and gets SIGTERM once its first
   metrics row lands. Fails unless it exits 75 printing ``preempted:
   checkpoint flushed``, ``trainer_state.ckpt`` verifies, one
   ``preempted`` row holds the flushed steps, the restart exits 0 naming
   the flushed epoch in its ``auto-resume`` line and warms its ring up
   again before it trains, the rows' steps are monotonic with unique
   epoch rows to the end, and only the newest 3 numbered checkpoints
   remain.
9. The worker plane, through its entry points with no --device (the card
   is the default). (a) ``python -m handyrl_tpu_torch.train`` on phase
   5's config with ``batched_generation: false`` and 6 workers, 2 epochs
   of 128 episodes after 128: a local cluster of a spawned gather and 6
   spawned worker processes, each playing its tasks one ply at a time on
   the card (K1's serving form at the 8-row bucket), the learner training
   on the graphed step. Fails unless it exits 0 with finite losses, wrote
   both checkpoints with their CRC sidecars, moved the params between
   them, launched K1, K2 and K3 once a training step (and the capture's
   warm-ups) and nothing else in the learner, its worker processes
   launched K1 and nothing else (``worker_kernel_launches``, from their
   last beacons), heard from all 6, the ledger ends with nothing
   outstanding, every episode counted once, and no gather or worker
   process is left. Prints its rates beside phase 5's, the fleet
   snapshot and a worker's time a generated ply. (b) ``--server`` and
   ``python -m handyrl_tpu_torch.worker`` with 4 workers over localhost
   TCP on free ports, 3 epochs of 128 episodes after 128,
   ``HANDYRL_TPU_CHAOS`` killing the host's gather once (12 s after it
   joined): fails unless both exit 0, the learner closed its epochs with
   (a)'s launch checks, the host's supervisor respawned the gather, and no
   episode counted twice (the ledger's re-issues and dropped duplicates
   are printed). Each run under PHASE9_TIMEOUT. Its telemetry
   (REMOTE_TELEMETRY: tracing every episode, alerts every second, the
   exporter on a free port, metrics rows): after the kill, one scrape of
   ``/metrics`` must show ``learner_episodes_returned_total`` > 0, the
   card's ``device_mem_bytes_in_use{device="cuda:0"}`` above 0 and at
   most its limit, and the worker host's counters under
   ``source="fleet"``; ``/statusz`` the progress, the fleet's hosts and
   the perf block in steady state; ``python -m handyrl_tpu_torch
   --status`` exits 0. After the run: the collated Chrome JSON holds a
   trace id whose task_assign, generate, upload, ingest and train_step
   events come from at least three processes, the host left its
   ``gather-death`` blackbox dump, the rows' alert blocks show
   ``heartbeat_misses`` fired, and the learner counted no retrace (a
   capture after warm-up is a finding, never exempted). The learner has
   ``profile_epochs: '2'`` (its rates are compared with no other run's):
   a torch.profiler trace with CUDA activity of its second epoch, which
   must be valid Chrome JSON with CUDA kernel events; names which of the
   graphed step's kernels (PROFILED) appear in it. Prints the scrape's
   latency and the trace events an episode. Then
   ``scripts/torch_trace_report.py --json`` on its trace directory and
   ``scripts/torch_postmortem.py --json`` on its blackbox directory must
   exit 0, the report with complete chains, the postmortem naming the
   killed gather among its ``gather-death`` dumps.
10. Network battles and the model specs, through ``python -m
   handyrl_tpu_torch`` with no --device, on a full-width GeeseNet
   (``torus_impl='pallas'``) and SimpleConv2dModel from seeded inits
   written as checkpoints. Fails first if port 9876 (the battle's fixed
   port) is taken; every process leads its own session, is waited for
   under PHASE10_TIMEOUT and killed whole at the end. (a) ``--eval-server
   8 1`` on Hungry Geese and four ``--eval-client CKPT 127.0.0.1``
   programs: every process exits 0, the report is the JAX format with 8
   games for each agent, one group of four children (each a fresh
   process on the card, joined by its program) launched K1 and nothing
   else, saw 8 outcomes the env gives, and each game's four sum to 0.
   (a') One Geese match from a fixed ``random`` seed with the server in
   a thread of this process and the four agents in spawned clients
   against ``exec_match`` of the same four card agents here: the same
   moves every ply and the same outcome; each command's round trip is
   timed. (b) ``--eval-server 20 2`` on TicTacToe (two spawned runners,
   each handed its group's sockets) and two client programs of two
   children each: every game counted for both agents, the children pair
   into groups whose outcomes cancel game by game. Beside each battle,
   the inline tournament of ``--eval`` with the checkpoint in every seat
   in this process. (c) The Geese checkpoint published to a registry,
   ``--serve`` on it (started first) and, at once, ``--eval
   registry://ROOT/geese@champion 8 1`` and ``--eval
   serve://127.0.0.1:PORT/geese@champion 8 1``: both count 8 games, the
   service's K1 launches (its ``status`` admin op: 0 just before, above
   0 just after, no other kernel); in this process the registry:// model
   equals the checkpoint's bit for bit on 24 boards and the serve:// one
   lies within SERVE_TOL; SIGTERM ends the service with 75.
11. The device branches besides the fused loop, through ``python -m
   handyrl_tpu_torch.train`` with no --device, and the export. (a) The
   split path at phase 5's config with ``device_generation`` alone (rollout
   chunks on the card, episodes spliced on the host, the host trainer), 2
   epochs of 128 episodes after 128: K1 under 'generation' and
   'evaluation', K1, K2 and K3 under 'training'. (b) The threaded replay
   trainer with device ingest at phase 6's config with ``fused_pipeline:
   false``, REPLAY_EPOCHS epochs, 8 steps a dispatch and
   ``max_sample_reuse`` 16, its evaluation
   against 'random' and phase 6's last checkpoint on the device evaluator:
   K1 under 'generation' and 'evaluation', K1, K2 and K5 under 'training'
   once a step, every metrics row's samples drawn within the cap x windows
   ingested plus one dispatch, and games against the checkpoint. (c) The
   host push (``device_replay`` with the host's self-play) on
   tictactoe.json, HOST_PUSH_EPOCHS epochs of 200 episodes after 200: K3
   under 'training' and no other kernel. (d) ``scripts/torch_export_model.py`` exports phase
   6's checkpoint to ``.pt2`` on the CPU; a fresh process loads it with
   ``ExportedModel`` on the card and holds 32 real boards to the
   checkpoint's ``ModelWrapper`` on the card (EXPORT_TOL), its K1 launched
   once an inference through the operator and nothing else; here the
   operator's CUDA route against the plain version at N in {1, 8}, and the
   latency of a serving forward with the operator against the direct
   wrapper call (in turns). Every run fails the script on a non-zero exit,
   a failed trainer, a kernel of its path that never launched or one off
   its path.
   Prints the branches' rates beside phases 5 and 6.
12. The device actor backend (``generation.backend: 'device'``), one
   JSON line. (a) ``DeviceActorEngine`` in this process on TicTacToe
   (full-width SimpleConv2dModel, two seeded model ids in two slots), one
   block of 64 stamped tasks in strict mode ('g' tasks and 'e' tasks
   against 'random'): no task deferred, every episode byte-equal
   (``connection.pack``) to the host ``Generator``'s record of the task on
   the card; divergences (lanes rerun on the host) reported. (b) The
   engine on Hungry Geese at full width (GeeseNet, ``torus_impl
   'pallas'``), 'device' records, two blocks of 64 tasks ('g' self-play
   and cross pairings, 'e' against 'random' and 'rulebase') with the slot
   -> model id maps (1, 2) and (3, 4), every count 0 just before: every
   lane finishes with ``record_version: 1``, one graph capture and one
   chunk program over both maps, K1 launched chunks x 16 x 2 times and
   nothing else, and the recorded probabilities and values within
   POLICY_TOL of the slot's model on the recorded boards; chunk ms by
   CUDA events, block seconds, the fill ratio. (c) ``python -m
   handyrl_tpu_torch.train`` on phase 5's config with
   ``batched_generation: false``, one ``DeviceActorGather`` (64 lanes,
   16-ply chunks, 2 slots), 2 epochs of 128 episodes after 128,
   VTRACE/VTRACE: exit 0, K1, K2 and K5 once a training step in the
   learner and nothing else, every episode counted once, the stamped
   episodes the engine's, no None payload, one capture, K1 in the gather;
   episodes/s, the trainer's wait share, the deferred tasks. (d)
   ``--server`` on tictactoe.json and ``python -m
   handyrl_tpu_torch.worker`` with ``worker_args.backend: 'device'`` over
   localhost TCP, DA_REMOTE_EPOCHS epochs: both exit 0, every episode
   counted once, K3
   once a step in the learner. Each run under PHASE12_TIMEOUT.
13. ConnectX and the recurrent GeeseNetLSTM, each run with every count 0
   at its start. (a) ConnectX: ``python -m handyrl_tpu_torch.train`` on
   tictactoe.json's train_args with ``env_args.env: 'ConnectX'`` (B=128,
   T=16, TD/TD, the full-width ConnectFourNet), CX_HOST_EPOCHS epochs on
   the host learner and CX_EPOCHS on the fused loop's 'turn' layout
   (config.yaml's device lines): exit 0, finite losses, K3 (P=2) in
   training and nothing else; one strict device actor block of 64 tasks
   ('g' and 'e' against 'random' and 'rulebase') byte-equal to the host
   Generator on the card; the twin's ``greedy_action`` on CX_BOARDS boards
   on the card equal to the host's ``rule_based_action``; a CX_GAMES-game
   tournament of the host learner's checkpoint against 'rulebase' in
   CX_PROCS spawned processes, every game counted. (b) GeeseNetLSTM at
   full width (filters 32, 4 stem blocks; no trunk kernel, as in the JAX
   package): ``python -m handyrl_tpu_torch.serving`` answers four geese a
   ply for LSTM_SERVE_PLIES plies, each request carrying its goose's state
   from the previous reply, every policy, value and next state within
   POLICY_TOL of a CPU forward of the same weights and state chain; the
   host learner on phase 5's config (episodes cut to 64 + 64,
   LSTM_EPOCHS epochs) and the fused loop on phase 6's (LSTM_FUSED_EPOCHS
   epochs: its metrics arrive a dispatch late), both with ``net_kind:
   'lstm'``, VTRACE/VTRACE, burn-in LSTM_BURN_IN: exit 0, finite losses,
   K5 in training and nothing else; one recurrent update step graphed at
   B=64, T=16+4 (CUDA events over LSTM_STEP_REPS replays); the device
   evaluator against 'random' and the host learner's checkpoint (its own
   recurrent state), one captured chunk; one device actor block of 64
   tasks on recurrent lanes ('device' records), each goose's recorded
   probability and value within POLICY_TOL of its slot's model run over
   its observations with the state carried. Prints episodes/s, the
   trainers' wait share, peak memory; each learner under
   PHASE13_TIMEOUT.
14. Geister and ParallelTicTacToe, and norm_kind 'batch' through the
   update step, the checkpoints and inference, one JSON line with each
   part's seconds (budget 150 s). Its learner processes ((b), (c) and
   (f)) start before phase 13 and run beside it. (a) ``python -m
   handyrl_tpu_torch.serving`` on a full-width GeisterNet('batch',
   'spatial') with seeded weights and running averages off their init:
   both seats for G_SERVE_PLIES plies, each request carrying its seat's
   DRC state, every policy, value and next state within POLICY_TOL of a
   CPU forward in inference mode, and G_BATCHED requests coalesced into
   one batch against each sent alone. (b) The host learner on the JAX
   package's 'geister' row (B=32, T=16, burn-in 4, 32 envs, observation)
   with 'batch' and 'spatial', its depth cut to one epoch of G_UPDATE (4)
   episodes after G_MINIMUM (32) (the row: 100 after 200; its host
   self-play is Python-bound): exit 0, finite losses, K3 twice a step
   (value and return, P=2) and no other kernel, and the checkpoint's
   running averages, read by the JAX-layout reader, moved off their
   init. (c) The fused 'turn' loop on
   'geister-fused-sp-bn' (32-ply chunks, 4 SGD steps a chunk), its depth
   cut to G_FUSED_EPOCHS (2) epochs of 32 episodes after 64 (the row:
   100 after 200): the same checks, its device evaluator against
   'random' and (b)'s checkpoint; in this process a small fused pipeline
   at full width whose ``refresh_actor`` leaves the actor's parameters
   and running averages equal to the trainer's. (d) The recurrent
   GeisterNet step at B=32, T=16+4 (TD/TD, the wide layout): eager and
   graphed on the card against each other and the CPU step (phase 4's
   tolerances; the running averages within STATS_RTOL), K3 only, the
   graph's replay timed by CUDA events. (e) The same for GeeseNet('batch',
   'pad'), one VTRACE window batch (B=16, T=16): K5 only. (f) The host
   learner on tictactoe.json's train_args, not turn-based, on
   ParallelTicTacToe, PTTT_EPOCHS epochs: K3 only. (g) One device actor
   block of DA_LANES Geister tasks ('device' records, recurrent lanes):
   every task answered, the moments the acting seat's alone, no kernel.
15. ``compute_dtype: 'bfloat16'`` (the JAX headline's dtype), then
   GeeseFormer, one JSON line with each part's seconds (budget 100 s).
   (a), which runs right after phase 2 (late in the script torch.profiler
   records no kernel, and it times K2's phases apart): the bf16 forms of K1 (serving and training), K2a and K2b at full
   width on real boards, N in BF16_NS, against their plain bf16 versions
   (BF16_TOL of each output's largest element; y's mean error within
   BF16_MEAN_TOL; the training form's output equal to the serving
   form's), timed with CUDA events (K2's phases by the profiler) beside
   the plain versions and the yardsticks: the 'pad' trunk in bf16
   (cuDNN's bf16 convs, the bf16 norms; autograd through it for K2) and
   cuDNN's bf16 weight grads for K2b; bounds over 989 TFLOP/s dense bf16
   and 3.35 TB/s. (b) ``python -m handyrl_tpu_torch.bench --device cuda
   --compute-dtype bfloat16``: finite losses, both forms timed, K1-bf16,
   K2-bf16 and K3 once a step and no fp32 trunk kernel. (c) The headline
   step in bf16 at B=16 on real boards, TD/TD, eager and graphed on the
   card against the CPU's bf16 step (BF16_STEP_RTOL, BF16_MU_RTOL, 2 lr)
   and each other, every param and moment fp32 after; the graph's replays
   timed. (d) ``python -m handyrl_tpu_torch.train`` on phase 6's config in
   bf16, BF16_FUSED_EPOCHS epochs: exit 0, finite losses, K1-bf16 in
   generation, K1-bf16, K2-bf16 and K5 in training, no fp32 trunk kernel;
   episodes/s. (e) TicTacToe's host learner in bf16 in this process
   (tests/test_bf16.py's config, 1 epoch): the net bf16, every param and
   Adam moment fp32 after, K3 in training. (f) A full-width GeeseFormer
   (dim 64, 4 layers, 4 heads) published to a registry and served by
   ``python -m handyrl_tpu_torch.serving``: four geese for FORMER_PLIES
   plies, each reply within POLICY_TOL of a CPU forward, no kernel (its
   attention is plain PyTorch, as the JAX package's is plain XLA). (g)
   ``Learner(args, net=GeeseFormer())`` in this process on phase 6's
   config, FORMER_EPOCHS epochs (K5 in training, every param moved), then
   one graphed VTRACE step (B=64, T=16) against the CPU step (phase 4's
   tolerances), its replays timed by CUDA events.
16. The durable training plane, streaming ingest and the IMPACT target
   network. (c) first, in this process: the graphed VTRACE step with the
   target (``streaming.target_clip`` 1.0) at B=128, T=16 on real boards
   beside the same step without it: a fresh target gives the no-target
   loss terms (within STEP_RTOL; the log says whether bit for bit), K1
   twice (training and serving forms), K2 and K5 once a replay (counts 0
   just before), both timed by CUDA events and the host clock; a
   ``sync_target`` is a ``copy_`` into the graph's buffers (one capture,
   the same pointers, the log-prob gap back to 0 on the next replay);
   IMPACT_LAG_STEPS lagged steps at STEP_B against the CPU's static step
   (STEP_RTOL of the terms, 2 lr a step of the params). (a) The SIGKILL
   drill: ``python -m handyrl_tpu_torch.train --server`` on Hungry Geese
   at full width (VTRACE, 32-ply streamed chunks, the target at clip 1.0
   synced every 2 epochs, the ``durability`` defaults, ``restart_epoch``
   -1) fed by one worker host whose gather is a DeviceActorGather
   ('device' records streaming through its emit sink); the learner is
   SIGKILLed once DURABLE_KILL_EPOCH epochs closed and a record was
   spooled past the snapshot, then restarted: it must restore its ledger
   book, replay the spool, keep the gather (reattached, zero respawns),
   finish DURABLE_EPOCHS with every episode counted once (restored +
   whole + streamed = counted, each assembly once) and launch K1 twice,
   K2 and K5 once a training step, K1 in the gather's chunk graph. It
   logs the MTTR (SIGKILL to the restarted trainer's first step, host
   clock) and episodes/s and plies/s before and after (metrics rows).
   (b) The host-worker stream: tictactoe.json streaming 2-ply chunks from
   a worker host of STREAM_WORKERS workers on the card, its gather
   SIGKILLed after the first epoch once the spool holds
   STREAM_OPEN_AT_KILL streams in flight: the supervisor respawns it, the
   stranded tasks re-issue under their sample keys and their regenerated
   chunks screen as duplicates (at least one), no key counted twice, K3
   once a step. Prints one ``{"phase16": ...}`` JSON line.
17. The league on the worker plane and the device actor (LEAGUE_*):
   ``python -m handyrl_tpu_torch.train --server`` on Hungry Geese at full
   width (VTRACE) with ``serving.publish`` (line LEAGUE_LINE) and
   ``league.enabled`` (anchors 'random' and 'rulebase', self-play 0.5,
   rating matches 0.25, the gate at margin 0 after 8 games), fed by one
   worker host whose gather is a DeviceActorGather (64 lanes, 16-ply
   chunks, 2 slots), LEAGUE_EPOCHS epochs of 64 episodes after 64: both
   exit 0; at least 2 distinct registry members seated in 'g' episodes;
   each epoch's promote/no-promote equal to ``should_promote`` recomputed
   on the book as it stood; the promotions booked, the metrics rows' and
   the manifest's champion agree; the journal's bytes unchanged by a
   ``RatingBook.load`` + ``save``; K1, K2 and K5 once a training step in
   the learner, K1 at least chunks x 16 x 2 in the gather. F6: ``python
   -m handyrl_tpu_torch --serve --config`` on the phase's config (a copy
   with ``serving.port`` 0 only if the default port is taken), started
   beside the learner, serves the learner's model_dir and, once the
   learner ended, answers one INFER for the gate's champion within
   SERVE_TOL of its checkpoint's forward; SIGTERM exits 75. Prints one
   ``{"phase17": ...}`` JSON line (members seated, rating matches by
   member and anchor, games, promotions, the champion, the gates, the
   journal's round trip, the device actor's lanes on slots and tasks on
   the host fallback). It runs beside 18(c) and (d).
18. The host inference engine of a gather (ENGINE_*), each learner
   through ``python -m handyrl_tpu_torch.train`` with no --device:
   (a) phase 9(a)'s config with ``inference.enabled`` and 8 workers in
   one gather: exit 0, finite losses, both checkpoints; the learner's K1,
   K2 and K3 once a training step and nothing else; the gather's engine
   K1 (serving form) and nothing else, more than one row a batch, no
   restart; the workers nothing at all, no failover; every episode
   counted once, no process left. Prints batches, rows a batch, the
   buckets, K1 a net-played ply, and episodes/s and plies/s beside 9(a)'s
   per-worker run. (b) In this process, on the full-width net: engine
   ticks of ENGINE_BUCKETS rows against ``model_act`` at the 8-row
   bucket, actions, masks, prob, value and the full-output policy equal
   bit for bit (F7's repair), one K1 launch a tick; the largest
   differences printed. (c) (a) cut (ENGINE_CHAOS_TRAIN) with
   ENGINE_CHAOS: at least one engine restart, one worker failover and
   one re-promotion, exit 0, every task answered once. (d) ``python -m
   handyrl_tpu_torch --serve --config`` on the learner's config (a copy
   naming a free port) and ENGINE_REMOTE_TRAIN's workers dialing it
   through ``serving.endpoint``: the service launches K1 and exits 75 on
   SIGTERM, no engine in the gather, the workers launch nothing until a
   failover and re-promote; the service's exporter (``serving.
   metrics_port``, a free port, on its ready line): one ``/metrics``
   scrape counts ``serve_requests_total`` above 0, ``/statusz`` has the
   SLO block and ``answered`` above 0 in its progress, ``python -m
   handyrl_tpu_torch --status`` exits 0. Prints one ``{"phase18": ...}``
   JSON line.
19. The serving fleet and the match gateway (FLEET_*, GW_*), through
   ``python -m handyrl_tpu_torch --serve-fleet`` and ``--gateway``. In
   this process first: a temporary registry with two seeded full-width
   GeeseNet versions (``torus_impl='pallas'``) on 'default' and a
   GeeseNetLSTM on 'lstm', each request's reference reply (``model_act``
   on the card), and (c)'s first part: GeeseNetLSTM's rows in engine ticks
   of LSTM_BUCKETS rows against ``model_act`` at 8, bit for bit (F8,
   repaired by ``models.blocks.row_blocks``). Then, beside phases 16, 17
   and 18 (it runs before them): (a) the fleet with 2 managed replicas on the card: every
   replica answers the references bit for bit; p50/p99 of FLEET_LATENCY
   requests one at a time; a burst of FLEET_BURST requests steered to one
   replica, SIGKILLed with the burst in flight: every reply the
   reference's bits, no client error, at least one replay; its respawn
   under its old name back to healthy (seconds printed) and answering the
   same bits; p50/p99 again; a rolling promote to version 2 warmed by
   both replicas before the flip, then version 2's bits; each replica's
   K1 launches equal to its engine's forwards (every forward K1's serving
   form). (b) ``--gateway`` over the fleet: GW_SESSIONS Hungry Geese
   sessions against ``default@champion``, held after GW_HOLD plies, the
   replica holding most SIGKILLed, released once the gateway rebuilt
   every stranded session from its journal: every match to its outcome,
   at least one rebuild, no mismatch, no drop, the respawn awaited. (c)
   The same with GW_LSTM_SESSIONS GeeseNetLSTM sessions (non-empty hidden
   cache and digest), the respawn not awaited (the drain follows). Every outcome in the RatingBook's journal; SIGTERM
   drains the gateway and the fleet to 75. The serving tier's telemetry
   rides the same runs (FLEET_TELEMETRY: every request and session
   traced, alerts every second; the resolver's and the gateway's
   exporters on free ports; the gateway alone under
   ``HANDYRL_TPU_SANITIZE=1``): after (a)'s respawn the resolver's
   ``/metrics`` shows ``fleet_replicas`` 2 and a respawn, its
   ``/statusz`` both replicas and ``heartbeat_misses`` fired; during
   (b)'s hold the gateway's ``/statusz`` lists a live session, and the
   same ones as its ``sessions`` op (a match may end before the hold);
   after (b)'s respawn a telemetry A/B on the warm fleet (AB_ORDER): a
   second gateway without the sanitizer plays rounds with its and the
   replicas' tracing switched off and on by the ``trace`` op, and the
   sanitized gateway rounds traced (matches/s, plies/s and ply p50/p99
   by arm; (a)-(c)'s own figures are the traced and sanitized ones);
   after (c) its ``/metrics`` counts every session opened and
   no drop, ``session_drop`` not fired, and ``--status`` (run beside (c))
   exits 0 against the resolver and the gateway; after the drain the
   gateway's sanitizer line reads 0 inversions and 0 leaked threads, and
   ``scripts/torch_trace_report.py --serve --json`` exits 0 with
   complete, routed and reconstruct chains, one of them from the
   gateway's process to a replica's (the router's replay link,
   ``router_replay``, is checked by the CPU tests alone: this process
   traces nothing, so (a)'s replays carry no id). Prints one
   ``{"phase19": ...}`` JSON line (latencies, respawn seconds, matches/s,
   plies replayed, the exporters, the A/B, the traces). Beside it (and phases 16-18), a child runs
   ``scripts/torch_aux_swa.py`` on the card over phase 7's checkpoints:
   exit 0, the reloaded average's probe finite.
21. The data-parallel plane (DP_*), its processes beside phases 11 and
   12: phase 6's fused loop (FUSED_CONFIG, solo, full-width GeeseNet,
   ``torus_impl='pallas'``) for DP_EPOCHS epochs with a checkpoint each,
   through ``python -m handyrl_tpu_torch.train``: (a) plainly and with a
   ``distributed`` block of world 1, at once: it fails unless every
   checkpoint file's bytes and the launches by path are equal; (b) over
   two ranks on the one card by the JAX package's variables (gloo,
   staged through the host: NCCL takes one card a rank): it fails unless
   both run the loop sharded over 2 devices, exit 0, end with the same
   params digest, counted the same steps and episodes, each launched K1
   in both forms, K2 and K5, and the trainer state's ``.layout`` reads
   data=2 over 2 processes; it prints the collective's ms a step by CUDA
   events and by the host clock; (c) (b)'s run directory resumed under a
   world of 1: it fails without the ``mesh-portable restore`` line and
   the trainer state resumed at (b)'s steps.
20. Prints one ``{"kernels": [...]}`` JSON line (K1, K2a, K2b, their bf16
   forms as rows of their own, K3-K5; K2a and K2b take their launches
   from K2's count, one of each a call, the bf16 rows from K2-bf16's; the
   fused loop's under ``learner_fused_*``, 5(b)'s under
   ``learner_shm_*``, the quick start's under ``quick_start_*``, 7(b)'s
   and 7(c)'s under ``quick_start_shm_*`` and ``quick_start_fused_*``,
   the scorer's under ``score_*``, phase 9's learners under
   ``workers_local_*`` and ``workers_remote_*`` and their worker
   processes under ``workers_*_worker_processes``, phase 10's client
   children under ``network_*_client_children`` and the service under
   ``network_serve_service``, phase 11's runs under ``split_*``,
   ``replay_*`` and ``host_push_*`` and the exported program's under
   ``export_exported_model``, phase 12's engine under
   ``device_actor_engine`` and its learners and gathers under
   ``device_actor_{local,remote}_*``, phase 13's learners under
   ``connectx_{host,fused}_*`` and ``lstm_{host,fused}_*`` and the LSTM
   service under ``lstm_service``, phase 14's learners under
   ``geister_{host,fused}_*`` and ``parallel_tictactoe_host_*``, its
   in-process steps under ``geister_recurrent_step`` and
   ``geese_batch_norm_step``, its service and device actor under
   ``geister_service`` and ``geister_device_actor``, phase 15's under
   ``bf16_bench``, ``bf16_step_graphed``, ``bf16_fused_*``,
   ``bf16_tictactoe_*``, ``former_service``, ``former_fused_*`` and
   ``former_step``, phase 16's under ``impact_step``,
   ``durable_drill_*`` (the restarted learner), ``durable_drill_gather``
   and ``stream_chaos_*``, phase 17's under ``league_*`` (the learner),
   ``league_gather`` and ``league_service``, phase 18's under
   ``engine_{local,chaos,remote}_*`` (the learners and their worker
   processes), ``engine_{local,chaos}_gather``, ``engine_remote_service``
   and ``engine_buckets``, phase 19's replica processes under
   ``fleet_<replica>_pid<pid>`` (each process's last status reply, before
   its kill or the drain), phase 21's under ``dp_{plain,world1,rank0,
   rank1,resume}_*``; K1's row also holds the operator's checks, the
   engine's buckets and the fleet's K1 by replica),
   the nvidia-smi line, and as the last line
   ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import time

SEED = 20261016
WIDTH = dict(cin=17, filters=32, layers=12, groups=8)
KERNEL_NS = (1, 8, 16, 32, 64, 100, 128, 256, 1024, 2048)
MAIN_PATH_N = 8          # four geese per ply, padded to the engine's bucket
TRAIN_N = 2048           # B*T*P of the headline update step
BWD_NS = (8, 64, 1024, 2048)
TARGET_TS, TARGET_PS = (1, 16), (1, 4)
TARGET_NS = (16, 64, 100, 128, 2048)   # lanes B*P
TARGET_PATH = (16, 1, 128)  # (T, P, lanes) of the headline step's targets
STEP_B = 16              # the in-process card-vs-CPU update step
# Tolerances, fp32 throughout with TF32 off: the kernel, the plain version
# and cuDNN sum the 9 taps and the GroupNorm statistics in different
# orders, and 13 normalised layers carry the difference (about 1e-5 at
# full width); the bounds leave an order of magnitude above that.
TOL = 2e-4               # max abs error of the trunk, kernel vs plain
POLICY_TOL = 1e-4        # served policy and value vs the local 'pad' forward
# K2: each grad's max abs error over its largest element. The kernel and
# the plain version sum the weight grads over N*77 pixels and the
# GroupNorm statistics in other orders; 1e-6 of the largest element is
# what that gives at full width, the bound leaves two orders above it.
BWD_TOL = 1e-4
# K3-K5: fp32 recursions of 16 steps on O(1) inputs; the kernel fuses
# multiply-adds the plain version rounds twice (about 1e-6 seen).
TARGET_TOL = 1e-4
# The update step on the card against the same step on the CPU (fp32 sums in
# other orders): each loss term within STEP_RTOL of the larger of |total|,
# |v| and 1 (p and ent are sums of terms of both signs, near 0 on this
# batch, so their own size is no scale); the pre-clip grad norm within
# STEP_NORM_RTOL of itself; the parameter update within 2 lr everywhere
# (Adam's first step is g / (|g| + 1e-8): an element whose grad rounds
# across 0 may move the other way) and within STEP_UPDATE_RTOL of the
# CPU's update in L2 norm. Those see the update's sign more than its size,
# so Adam's first moment after the step (0.1 x the clipped, decayed grad) is
# also held leaf by leaf: its max abs difference over the CPU's largest
# element of that leaf within STEP_MU_RTOL.
STEP_RTOL = 1e-4
STEP_NORM_RTOL = 1e-3
STEP_UPDATE_RTOL = 1e-2
STEP_MU_RTOL = 1e-3
# The graphed step against the eager step on the card, over 3 steps: the
# same kernels and ops in the same order, so equality is expected (the log
# says whether it held bit for bit). Should cuBLAS pick another algorithm
# for the heads' products under capture, their fp32 sums reassociate: the
# bounds are then those of tests/test_torch_train_step.py for fp32
# reassociation of this step: params within lr / 10 (Adam turns a grad near
# 1e-8 into a step of up to lr), Adam's moments within 1e-4 of each leaf's
# largest element, metrics within 1e-4 of max(|value|, 1). Count and steps
# are integers and must be equal.
GRAPH_PARAM_ATOL = 1e-6   # lr / 10 at the bench's lr of 1e-5
GRAPH_MOMENT_RTOL = 1e-4
GRAPH_METRIC_RTOL = 1e-4
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
PEAK_SOURCE = 'H100 SXM data sheet at 700 W'
# K1's saved normalised conv outputs (abs, as the trunk's output) and
# per-group rstd (relative: rstd is 1/std of conv outputs of any size)
RSTD_RTOL = 1e-4
SAVED_NS = (8, 1024, 2048)  # the serving bucket, the fused loop's and the
                            # update step's rows


def fail(msg):
    print('chip_smoke: FAIL: %s' % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    # the process's own stdout: phase 10's inline tournament swaps
    # sys.stdout for a moment in its thread, and a line another phase's
    # thread logs then must not land in that buffer
    print(msg, file=sys.__stdout__, flush=True)


def concurrently(*fns):
    """Run ``fns`` (each a part that waits on processes of its own and does
    no CUDA work in this process) in threads at once; their results in
    order. A failure in any (``fail`` exits through SystemExit) is raised
    here once all have ended."""
    import threading
    results, errors = [None] * len(fns), [None] * len(fns)

    def run(i, fn):
        try:
            results[i] = fn()
        except BaseException as exc:
            errors[i] = exc
    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for exc in errors:
        if exc is not None:
            raise exc
    return results


def in_background(fn):
    """Start ``fn`` (a part that waits on processes of its own and does no
    CUDA work in this process) in a thread; returns ``join``, which waits
    for it and returns its result or raises its failure (``fail`` exits
    through SystemExit)."""
    import threading
    box = {}

    def run():
        try:
            box['result'] = fn()
        except BaseException as exc:
            box['error'] = exc
    thread = threading.Thread(target=run)
    thread.start()

    def join():
        thread.join()
        if 'error' in box:
            raise box['error']
        return box['result']
    return join


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail('nvidia-smi failed: %s' % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(torch, fn, reps):
    """Mean device time of one call of ``fn`` over ``reps`` back-to-back
    calls (CUDA events, after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(torch, fn, reps):
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, timed with CUDA events. For kernels that take
    less time on the card than their wrapper takes on the host, where
    :func:`cuda_time_ms` would time the host."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(e):
    return getattr(e, 'self_device_time_total',
                   getattr(e, 'self_cuda_time_total', 0)) or 0


def kernel_ms(torch, fn, reps):
    """Device time of each kernel ``fn`` launches, per call of ``fn``, by
    kernel name: torch.profiler over ``reps`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: device_us(e) / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0}


def k2_kernel_ms(torch, fn, reps, label):
    """``kernel_ms`` of a K2 call, profiled once more when the trace lacks
    one of its phases' kernels (CUPTI has dropped a kernel's record from
    an otherwise complete trace); the callers still fail unless a trace
    shows every one."""
    by_kernel = kernel_ms(torch, fn, reps)
    for kernels in PHASES.values():
        if not all(any(name in k for k in by_kernel) for name in kernels):
            log('%s: the profiler\'s trace lacks %s (%s); profiling again'
                % (label, kernels, sorted(by_kernel)))
            return kernel_ms(torch, fn, reps)
    return by_kernel


def training_forward(torch, geese_trunk, x, weights, groups):
    """K1's training form: (y, acts, xhat, rstd) on the card."""
    saved = geese_trunk.training_buffers(x.shape[0], weights[3].shape[0],
                                         weights[0].shape[-1], groups,
                                         x.device)
    y = geese_trunk.trunk_forward(x, *weights, groups=groups, **saved)
    return y, saved['acts'], saved['xhat'], saved['rstd']


def saved_errors(torch, geese_trunk, x, weights, groups):
    """K1's training form against the plain training forward on the same
    input: max abs error of y, acts and xhat, and rstd's max relative
    error."""
    got = training_forward(torch, geese_trunk, x, weights, groups)
    torch.cuda.synchronize()
    ref = [torch.empty_like(t) for t in got[1:]]
    y = geese_trunk.trunk_forward_reference(x, *weights, groups=groups,
                                            acts=ref[0], xhat=ref[1],
                                            rstd=ref[2])
    for name, t in zip(('y', 'acts', 'xhat', 'rstd'), got):
        if not bool(torch.isfinite(t).all().item()):
            fail('geese_trunk training form: non-finite %s' % name)
    err = {name: (g - r).abs().max().item()
           for name, g, r in zip(('y', 'acts', 'xhat'), got, [y] + ref[:2])}
    err['rstd_rel'] = ((got[3] - ref[2]).abs() / ref[2].abs()).max().item()
    return err


def check_saved(err, what):
    log('%s: K1 training form vs plain: max abs err y %.3g, acts %.3g, xhat '
        '%.3g (tol %.0e); rstd max rel err %.3g (tol %.0e)' % (
            what, err['y'], err['acts'], err['xhat'], TOL, err['rstd_rel'],
            RSTD_RTOL))
    if not (max(err['y'], err['acts'], err['xhat']) <= TOL
            and err['rstd_rel'] <= RSTD_RTOL):
        fail('%s: K1\'s saved tensors disagree with the plain training '
             'forward' % what)


def game_observations(make_env, count, seed):
    """``count`` real observations from random Hungry Geese play."""
    import random
    rng = random.Random(seed)
    env = make_env({'env': 'HungryGeese', 'id': seed})
    obs = []
    while len(obs) < count:
        if env.terminal():
            env.reset()
        for p in env.turns():
            obs.append(env.observation(p))
        env.step({p: rng.randrange(4) for p in env.turns()})
    return obs[:count]


# ------------------------------------------------------------------ phases

def phase_build(cuda_build):
    nvcc = cuda_build.nvcc_path()
    version = subprocess.run([nvcc, '--version'], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    t0 = time.monotonic()
    built = cuda_build.build()
    log('build: %s (%s): %s in %.2f s wall' % (
        nvcc, version, ', '.join('%s %.2f s' % kv for kv in built.items())
        or 'all libraries current', time.monotonic() - t0))
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                log('  %s: %s' % (name, line.strip()))
    cuobjdump = os.path.join(os.path.dirname(nvcc), 'cuobjdump')
    hmma = sass_hmma_counts(cuobjdump,
                            cuda_build.library_path('geese_trunk'))
    for kernel, count in sorted(hmma.items()):
        log('  SASS of %s: %d HMMA instructions' % (kernel, count))
    for name, kernel in (('K1', 'trunk_fwd_kernel'),
                         ('K2b', 'trunk_wgrad_kernel')):
        for form in ('float', 'bf16'):   # both forms, both widths
            counts = {k: c for k, c in hmma.items()
                      if k.startswith(kernel) and k.endswith(form + '>')}
            if len(counts) != 2 or not all(counts.values()):
                fail('%s (%s, %s form) does not run on the tensor cores: '
                     'HMMA counts %s' % (name, kernel, form, counts))
    return hmma


def sass_hmma_counts(cuobjdump, library):
    """The tensor-core mma instructions (HMMA) in the SASS of each trunk
    kernel in ``library``, by kernel, width and activation type (the fp32
    and the bf16 forms): {'trunk_fwd_kernel<32,float>': count,
    'trunk_fwd_kernel<32,bf16>': count, ...}."""
    import re
    out = subprocess.run([cuobjdump, '--dump-sass', library],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail('cuobjdump failed on %s: %s' % (library, out.stderr.strip()))
    counts, kernel = {}, None
    for line in out.stdout.splitlines():
        if 'Function : ' in line:
            m = re.search(r'(trunk_[a-z]+_kernel)ILi(\d+)E(f|13__nv_bfloat16)E',
                          line)
            kernel = ('%s<%s,%s>' % (m.group(1), m.group(2),
                                     'float' if m.group(3) == 'f' else 'bf16')
                      if m else None)
            if kernel:
                counts[kernel] = 0
        elif kernel and 'HMMA' in line:
            counts[kernel] += 1
    return counts


def trunk_bound_ms(n, cin, filters, layers, groups, training=False):
    """Least time for K1 at batch n: the larger of its operations over the
    peak of the units it runs on and its bytes (read once / written once)
    over the HBM rate. The 9-tap products run on the tensor cores in
    3xTF32, three TF32 products per fp32 multiply-add, over the TF32 peak
    (GroupNorm's ~1% is left out, which only lowers the bound); the bytes
    are the input, the weights and the output, and in the training form
    (``training``) also what it saves for K2: acts, xhat and rstd."""
    flops = n * 2 * 77 * 9 * (cin * filters + layers * filters * filters)
    weights = 9 * cin * filters + layers * 9 * filters * filters \
        + 2 * filters * (layers + 1)
    nbytes = 4 * (n * 77 * cin + weights + n * 77 * filters)
    if training:
        nbytes += 4 * n * (layers * 77 * filters
                           + (layers + 1) * (77 * filters + groups))
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def trunk_net(torch, GeeseNet):
    """A full-width 'pad' GeeseNet on the card with seeded weights, the
    norm's scale and bias random too, and its trunk operands."""
    gen = torch.Generator().manual_seed(SEED)
    net = GeeseNet(filters=WIDTH['filters'], layers=WIDTH['layers'],
                   torus_impl='pad', generator=gen)
    with torch.no_grad():   # exercise the norm's scale and bias too
        for p in (net.stem_scale, net.block_scale):
            p.uniform_(0.5, 1.5, generator=gen)
        for p in (net.stem_bias, net.block_bias):
            p.normal_(0.0, 0.1, generator=gen)
    net = net.cuda().eval()
    return net, (net.stem_w, net.stem_scale, net.stem_bias, net.block_w,
                 net.block_scale, net.block_bias)


def phase_kernels(torch, geese_trunk, GeeseNet, make_env):
    """K1 against its plain version and the library yardstick."""
    from handyrl_tpu_torch.ops import kernel_launches
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net, weights = trunk_net(torch, GeeseNet)
    import numpy as np
    all_obs = np.stack(game_observations(make_env, max(KERNEL_NS), SEED))
    rows = {}
    with torch.no_grad():
        for n in KERNEL_NS:
            obs = torch.from_numpy(all_obs[:n]).cuda()
            x = obs.permute(0, 2, 3, 1).contiguous()     # (N,7,11,17)

            def kernel():
                return geese_trunk.trunk_forward(x, *weights,
                                                 groups=WIDTH['groups'])

            def plain():
                return geese_trunk.trunk_forward_reference(
                    x, *weights, groups=WIDTH['groups'])

            def library():
                return net.trunk(x)

            got = kernel()
            torch.cuda.synchronize()
            ref = plain()
            err = (got - ref).abs().max().item()
            finite = bool(torch.isfinite(got).all().item())
            lib_err = (library() - ref).abs().max().item()
            bound, bound_by, flops, nbytes = trunk_bound_ms(
                n, WIDTH['cin'], WIDTH['filters'], WIDTH['layers'],
                WIDTH['groups'])
            row = {'n': n, 'max_abs_err': err,
                   'ms': cuda_time_ms(torch, kernel, 200),
                   'device_ms': sum(
                       t for k, t in kernel_ms(torch, kernel, 20).items()
                       if 'trunk_fwd_kernel' in k),
                   'plain_ms': cuda_time_ms(torch, plain, 20),
                   'library_ms': cuda_time_ms(torch, library, 50),
                   'bound_ms': bound, 'bound_by': bound_by,
                   'flops': flops, 'bytes': nbytes}
            rows[n] = row
            log('geese_trunk N=%-3d max_abs_err %.3g (tol %.0e, pad-trunk '
                'vs plain %.3g)  kernel %.4f ms (%.4f ms on the card by the '
                'profiler)  plain %.4f ms  library %.4f ms  bound %.4f ms '
                '(%s)  launches so far %d' % (
                    n, err, TOL, lib_err, row['ms'], row['device_ms'],
                    row['plain_ms'], row['library_ms'], bound, bound_by,
                    kernel_launches()['geese_trunk']))
            if not finite:
                fail('geese_trunk produced non-finite values at N=%d' % n)
            if not err <= TOL:
                fail('geese_trunk disagrees with its plain version at N=%d: '
                     'max abs err %.3g > %.0e' % (n, err, TOL))
            if n in SAVED_NS:
                # the training form: also acts, xhat and rstd for K2
                check_saved(saved_errors(torch, geese_trunk, x, weights,
                                         WIDTH['groups']), 'N=%d' % n)
                row['train_ms'] = cuda_time_ms(torch, lambda: training_forward(
                    torch, geese_trunk, x, weights, WIDTH['groups']), 50)
                tb, tb_by, _, tbytes = trunk_bound_ms(
                    n, WIDTH['cin'], WIDTH['filters'], WIDTH['layers'],
                    WIDTH['groups'], training=True)
                row['train_bound_ms'] = tb
                log('geese_trunk N=%-3d training form %.4f ms (serving form '
                    '%.4f ms), bound %.4f ms (%s; %.4g GFLOP as 3xTF32, %.4g '
                    'MB)' % (n, row['train_ms'], row['ms'], tb, tb_by,
                             flops / 1e9, tbytes / 1e6))
    return rows


def bwd_bounds_ms(n, cin, filters, layers, groups):
    """Least times for K2's two phases at batch n as the update step calls
    it (no dx), each the larger of its operations over the peak of the
    units it runs on and its bytes (inputs read once, outputs written once)
    over the HBM rate. Phase A (trunk_bwd_kernel): the blocks' transposed
    convs in 3xTF32 on the tensor cores, three TF32 products per fp32
    multiply-add, over the TF32 peak; it reads xhat, rstd, acts (the ReLU
    masks), y, dy and the weights and writes dc and the scale and bias
    grads. Phase B (trunk_wgrad_kernel + column_sum): the weight products,
    also in 3xTF32 over the TF32 peak; it reads x, acts, dc and the scale
    and bias grads and writes the grads. Returns {phase: (ms, bound_by,
    flops, bytes)}."""
    nl = layers + 1
    weights = 9 * cin * filters + layers * 9 * filters * filters
    grads = weights + 2 * filters * nl
    px = 77 * filters
    a_flops = n * 2 * 77 * 9 * layers * filters * filters
    a_bytes = 4 * (n * (nl * px + nl * groups + layers * px + 2 * px
                        + nl * px + nl * 2 * filters) + weights + 2 * nl * filters)
    b_flops = n * 2 * 77 * 9 * (cin * filters + layers * filters * filters)
    b_bytes = 4 * (n * (77 * cin + layers * px + nl * px + nl * 2 * filters)
                   + grads)
    out = {}
    for phase, t_ops, flops, nbytes in (
            ('a', 3 * a_flops / PEAK_TF32_FLOPS, a_flops, a_bytes),
            ('b', 3 * b_flops / PEAK_TF32_FLOPS, b_flops, b_bytes)):
        t_bytes = nbytes / PEAK_BYTES
        out[phase] = (1e3 * max(t_ops, t_bytes),
                      'operations' if t_ops >= t_bytes else 'bytes', flops,
                      nbytes)
    return out


PHASES = {'a': ('trunk_bwd_kernel',), 'b': ('trunk_wgrad_kernel',
                                             'column_sum')}


def layer_inputs_and_dc(geese_trunk, x, weights, dy, groups, saved,
                        bf16=False):
    """What K2b reads: each layer's input (x, then each block's) and its
    conv-output grad dc, from the plain backward's steps on the training
    forward's saved tensors; with ``bf16``, the bf16 form's (dc and the
    block grads rounded to bf16 where the plain bf16 backward rounds them,
    held in fp32)."""
    stem_w, stem_scale, _, block_w, block_scale, _ = weights
    layers = block_w.shape[0]
    inputs = [x] + [saved['acts'][:, i] for i in range(layers)]
    outs = inputs[1:] + [saved['y']]
    ws, scales = [stem_w] + list(block_w), [stem_scale] + list(block_scale)

    def rd(t):
        return t.to(x.dtype).float() if bf16 else t
    dh, dcs = dy.float(), [None] * (layers + 1)
    for l in range(layers, -1, -1):
        g = dh * (outs[l] > 0)
        dcs[l] = rd(geese_trunk._group_norm_backward(
            g, saved['xhat'][:, l], saved['rstd'][:, l], scales[l],
            groups)[0])
        if l > 0:
            dh = rd(g + rd(geese_trunk._conv_transpose(dcs[l], rd(ws[l]))))
    return inputs, dcs


def wgrad_yardsticks(torch, geese_trunk, inputs, dcs, ref_w):
    """K2b's plain version (the 13 plain weight grads) and cuDNN's weight
    grads of the same 13 torus convs (fp32, TF32 off), each checked against
    the plain backward's weight grads ``ref_w`` and timed: the plain
    version with CUDA events, cuDNN by CUDA-graph replay (the wrapper's
    host cost would hide it). The circular padding and NCHW copies are
    made before the timed region. Returns (plain ms, cuDNN ms, cuDNN's max
    error over each grad's largest element)."""
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    padded = [F.pad(h.permute(0, 3, 1, 2).contiguous(), (1, 1, 1, 1),
                    mode='circular') for h in inputs]
    dcs_nchw = [d.permute(0, 3, 1, 2).contiguous() for d in dcs]
    sizes = [(d.shape[-1], h.shape[-1], 3, 3) for h, d in zip(inputs, dcs)]

    def plain():
        return [geese_trunk._conv_weight_grad(h, d)
                for h, d in zip(inputs, dcs)]

    def library():
        return [torch.nn.grad.conv2d_weight(p, size, d)
                for p, size, d in zip(padded, sizes, dcs_nchw)]

    got = library()
    err = max(((g.permute(2, 3, 1, 0) - r).abs().max() / r.abs().max()).item()
              for g, r in zip(got, ref_w))
    return (cuda_time_ms(torch, plain, 5), graph_time_ms(torch, library, 20),
            err)


def phase_backward(torch, geese_trunk, GeeseNet, make_env):
    """K2 against its plain version and torch autograd's backward through
    the 'pad' trunk; each phase timed by the profiler."""
    import numpy as np
    net, weights = trunk_net(torch, GeeseNet)
    all_obs = np.stack(game_observations(make_env, max(BWD_NS), SEED + 2))
    gen = torch.Generator().manual_seed(SEED + 3)
    names = ('dx', 'd_stem_w', 'd_stem_scale', 'd_stem_bias', 'd_block_w',
             'd_block_scale', 'd_block_bias')
    L, F, G = WIDTH['layers'], WIDTH['filters'], WIDTH['groups']
    rows = {}
    for n in BWD_NS:
        x = torch.from_numpy(all_obs[:n]).cuda().permute(0, 2, 3, 1) \
            .contiguous()
        dy = torch.randn(n, 7, 11, F, generator=gen).cuda()
        with torch.no_grad():
            y, acts, xhat, rstd = training_forward(torch, geese_trunk, x,
                                                   weights, G)
            saved = dict(acts=acts, y=y, xhat=xhat, rstd=rstd)

            def kernel(need_dx=False):
                return geese_trunk.trunk_backward(
                    x, *weights, dy, groups=G, need_dx=need_dx, **saved)

            def plain():
                return geese_trunk.trunk_backward_reference(
                    x, *weights, dy, groups=G, need_dx=False, **saved)

            got = kernel(need_dx=True)
            torch.cuda.synchronize()
            ref = geese_trunk.trunk_backward_reference(x, *weights, dy,
                                                       groups=G, **saved)
            errs = {}
            for name, g, r in zip(names, got, ref):
                if not bool(torch.isfinite(g).all().item()):
                    fail('geese_trunk_bwd: non-finite %s at N=%d' % (name, n))
                errs[name] = ((g - r).abs().max() / r.abs().max()).item()
            ms = cuda_time_ms(torch, kernel, 20)
            plain_ms = cuda_time_ms(torch, plain, 5)
            by_kernel = k2_kernel_ms(torch, kernel, 10, 'K2 N=%d' % n)
            inputs, dcs = layer_inputs_and_dc(geese_trunk, x, weights, dy, G,
                                              saved)
            b_plain_ms, b_library_ms, b_library_err = wgrad_yardsticks(
                torch, geese_trunk, inputs, dcs, [ref[1]] + list(ref[4]))
            del inputs, dcs
        # the yardstick: autograd through the cuDNN trunk, backward only
        with torch.enable_grad():
            yp = net.trunk(x)
            library_ms = cuda_time_ms(torch, lambda: torch.autograd.grad(
                yp, weights, dy, retain_graph=True), 5)
        del yp
        err = max(errs.values())
        bounds = bwd_bounds_ms(n, WIDTH['cin'], F, L, G)
        row = {'n': n, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
               'library_ms': library_ms}
        for phase, kernels in PHASES.items():
            times = [t for k, t in by_kernel.items()
                     if any(name in k for name in kernels)]
            if len(times) != len(kernels):
                fail('the profiler shows %d of K2 phase %s\'s kernels %s: %s'
                     % (len(times), phase, kernels, sorted(by_kernel)))
            bound, bound_by, flops, nbytes = bounds[phase]
            row[phase] = {'ms': sum(times), 'bound_ms': bound,
                          'bound_by': bound_by, 'flops': flops,
                          'bytes': nbytes}
        row['b'].update(plain_ms=b_plain_ms, library_ms=b_library_ms,
                        library_err=b_library_err)
        rows[n] = row
        log('geese_trunk_bwd N=%-4d max err / max |grad| %.3g (tol %.0e; %s)'
            '  kernel %.4f ms  plain %.4f ms  library %.4f ms' % (
                n, err, BWD_TOL, ', '.join('%s %.2g' % kv for kv in
                                           errs.items()), ms, plain_ms,
                library_ms))
        for phase, kernels in PHASES.items():
            r = row[phase]
            log('  phase %s (%s) %.4f ms a call (profiler), bound %.4f ms '
                '(%s; %.4g GFLOP, %.4g MB)' % (
                    phase, ' + '.join(kernels), r['ms'], r['bound_ms'],
                    r['bound_by'], r['flops'] / 1e9, r['bytes'] / 1e6))
        b = row['b']
        log('  phase b: plain weight grads %.4f ms; cuDNN weight grads of the '
            '13 convs %.4f ms (CUDA-graph replay; max err / max |grad| %.3g '
            'against the plain version) beside the kernel\'s %.4f ms' % (
                b['plain_ms'], b['library_ms'], b['library_err'], b['ms']))
        if not err <= BWD_TOL:
            fail('geese_trunk_bwd disagrees with its plain version at N=%d'
                 % n)
        if not b['library_err'] <= BWD_TOL:
            fail('cuDNN\'s weight grads disagree with the plain version at '
                 'N=%d: the yardstick computes another function' % n)
    return rows


def phase_narrow(torch, geese_trunk, n=64, filters=16, layers=2):
    """K1 and K2 at the kernels' other width, F=16 (no main path runs it
    yet), against their plain versions; correctness only."""
    gen = torch.Generator().manual_seed(SEED + 5)

    def rand(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=gen)).cuda()
    cin, groups = WIDTH['cin'], min(8, filters)
    weights = (rand(3, 3, cin, filters, scale=(9 * cin) ** -0.5),
               rand(filters, scale=0.2, shift=1.0), rand(filters, scale=0.1),
               rand(layers, 3, 3, filters, filters,
                    scale=(9 * filters) ** -0.5),
               rand(layers, filters, scale=0.2, shift=1.0),
               rand(layers, filters, scale=0.1))
    x, dy = rand(n, 7, 11, cin), rand(n, 7, 11, filters)
    with torch.no_grad():
        check_saved(saved_errors(torch, geese_trunk, x, weights, groups),
                    'F=%d L=%d N=%d' % (filters, layers, n))
        y, acts, xhat, rstd = training_forward(torch, geese_trunk, x,
                                               weights, groups)
        saved = dict(acts=acts, y=y, xhat=xhat, rstd=rstd)
        y_err = (y - geese_trunk.trunk_forward_reference(
            x, *weights, groups=groups)).abs().max().item()
        got = geese_trunk.trunk_backward(x, *weights, dy, groups=groups,
                                         **saved)
        ref = geese_trunk.trunk_backward_reference(x, *weights, dy,
                                                   groups=groups, **saved)
        g_err = max(((g - r).abs().max() / r.abs().max()).item()
                    for g, r in zip(got, ref))
    log('F=%d L=%d N=%d: geese_trunk max_abs_err %.3g (tol %.0e), '
        'geese_trunk_bwd max err / max |grad| %.3g (tol %.0e)' % (
            filters, layers, n, y_err, TOL, g_err, BWD_TOL))
    if not (y_err <= TOL and g_err <= BWD_TOL):
        fail('the F=%d kernels disagree with their plain versions' % filters)


def target_bound_ms(kind, T, n):
    """Least time for K3-K5 at (T, n): bytes only (a few flops a step):
    values, rewards, lambda (and rhos, cs for V-Trace) read once, the
    bootstrap row, targets and advantages written once."""
    reads = 5 if kind == 'vtrace' else 3
    nbytes = 4 * ((reads + 2) * T * n + n)
    return 1e3 * nbytes / PEAK_BYTES, 'bytes', nbytes


def phase_targets(torch, targets):
    """K3-K5 against their plain versions at every (T, P, N) of TARGET_TS,
    TARGET_PS and TARGET_NS (B = N / P rows), each timed by graph replay
    (the kernel's device time) and through the wrapper, beside the plain
    version's time and the byte bound. ``returns`` is the outcome, one row
    a trajectory, whose bootstrap row the kernels read in place."""
    import numpy as np
    rows = {}
    for T in TARGET_TS:
        for P in TARGET_PS:
            for n in TARGET_NS:
                rows.update(target_rows(torch, targets, np, T, P, n))
    # the turn-based step's (phase 7): two players, B=128
    rows.update(target_rows(torch, targets, np, *QUICK_TARGETS))
    # the recurrent host learner's (phase 13(b)): four geese, B=128
    rows.update(target_rows(torch, targets, np, *LSTM_TARGETS))
    return rows


def target_rows(torch, targets, np, T, P, n):
    B = n // P
    rng = np.random.RandomState(SEED + 7 * n + 3 * T + P)
    shape = (B, T, P, 1)

    def arr(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()
    values = arr(rng.uniform(-1, 1, shape))
    returns = arr(np.sign(rng.randn(B, 1, P, 1)))
    rewards = arr(0.1 * rng.randn(*shape))
    lam = arr(0.95 + 0.05 * (rng.rand(*shape) < 0.2))
    rhos = arr(rng.uniform(0, 1, shape))
    cs = arr(rng.uniform(0, 1, shape))
    rows = {}
    for kind in ('td_lambda', 'upgo', 'vtrace'):
        args = (values, returns, rewards, lam, 0.99) + (
            (rhos, cs) if kind == 'vtrace' else ())
        kernel = getattr(targets, kind + '_kernel')
        plain = getattr(targets, kind)
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        finite = all(bool(torch.isfinite(g).all().item()) for g in got)
        ms = graph_time_ms(torch, lambda: kernel(*args), 100)
        call_ms = cuda_time_ms(torch, lambda: kernel(*args), 200)
        plain_ms = cuda_time_ms(torch, lambda: plain(*args), 20)
        bound, bound_by, nbytes = target_bound_ms(kind, T, n)
        rows[(kind, T, P, n)] = {
            'n': n, 'T': T, 'P': P, 'max_abs_err': err, 'ms': ms,
            'call_ms': call_ms, 'plain_ms': plain_ms, 'library_ms': None,
            'bound_ms': bound, 'bound_by': bound_by, 'bytes': nbytes}
        log('%-9s T=%-2d P=%d N=%-4d max_abs_err %.3g (tol %.0e)  kernel '
            '%.4f ms on the card (graph replay; %.4f ms a call through the '
            'wrapper)  plain %.4f ms  bound %.6f ms (bytes)' % (
                kind, T, P, n, err, TARGET_TOL, ms, call_ms, plain_ms,
                bound))
        if not finite or not err <= TARGET_TOL:
            fail('%s disagrees with its plain version at T=%d P=%d N=%d'
                 % (kind, T, P, n))
    return rows


def read_ready_line(proc, timeout):
    """The service's JSON ready line from its stdout."""
    deadline = time.monotonic() + timeout
    buf = b''
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            fail('the service exited with %s before it was ready'
                 % proc.returncode)
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if not ready:
            continue
        chunk = os.read(proc.stdout.fileno(), 65536)
        buf += chunk
        for line in buf.decode('utf-8', 'replace').splitlines():
            if line.startswith('{') and 'serving_ready' in line:
                return json.loads(line)['serving_ready']
    fail('no ready line from the service within %.0f s' % timeout)


def play_games(client, make_env, sample_seed, np):
    """Four-goose games through the service until two of them reached ten
    plies; every reply is checked. Returns (games, first obs, the seconds
    of each ply's round trip: its requests pipelined, then collected)."""
    OPPOSITE = {0: 1, 1: 0, 2: 3, 3: 2}
    long_games, games, first_obs, ply_s = 0, 0, None, []
    while long_games < 2:
        if games >= 12:
            fail('no two games reached ten plies in 12 games')
        env = make_env({'env': 'HungryGeese', 'id': SEED + games})
        env.reset()
        last, ply = {}, 0
        while not env.terminal() and ply < 60:
            t0 = time.perf_counter()
            rids = {}
            for p in env.turns():
                obs = env.observation(p)
                if first_obs is None:
                    first_obs = obs
                legal = [a for a in range(4) if a != OPPOSITE.get(last.get(p))]
                rids[p] = (client.submit(
                    'default@champion', obs, legal=legal,
                    seed=sample_seed(SEED, (games, p), ply)), legal)
            actions = {}
            for p, (rid, legal) in rids.items():
                rep = client.collect(rid, timeout=120)
                value = np.asarray(rep['value'])
                if rep['action'] not in legal:
                    fail('illegal action %r for legal %s' % (rep['action'],
                                                              legal))
                if not (0.0 < float(rep['prob']) <= 1.0):
                    fail('sampled prob %r out of range' % rep['prob'])
                if value.shape != (1,) or not np.isfinite(value).all():
                    fail('bad value %r' % (rep['value'],))
                if not np.isfinite(np.asarray(rep['action_mask'])).all():
                    fail('non-finite action mask')
                actions[p] = rep['action']
            ply_s.append(time.perf_counter() - t0)
            env.step(actions)
            last.update(actions)
            ply += 1
        games += 1
        long_games += ply >= 10
    return games, first_obs, ply_s


def phase_main_path(torch, repo):
    import numpy as np
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.generation import sample_seed
    from handyrl_tpu_torch.model import ModelWrapper
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.serving.client import ServiceClient
    from handyrl_tpu_torch.serving.registry import ModelRegistry

    net = GeeseNet(filters=WIDTH['filters'], layers=WIDTH['layers'],
                   torus_impl='pallas',
                   generator=torch.Generator().manual_seed(SEED + 1))
    wrapper = ModelWrapper(net, device='cuda')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_')
    proc, client, log_file = None, None, None
    try:
        root = os.path.join(tmp, 'registry')
        ModelRegistry(root).publish('default', snapshot=wrapper.snapshot(),
                                    version=1, promote=True)
        log_path = os.path.join(tmp, 'service.log')
        log_file = open(log_path, 'wb')
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, '-m', 'handyrl_tpu_torch.serving', '--env',
             'HungryGeese', '--registry', root, '--port', '0'],
            cwd=repo, stdout=subprocess.PIPE, stderr=log_file)
        ready = read_ready_line(proc, timeout=300)
        log('service: ready on port %d (%s) after %.1f s' % (
            ready['port'], ready['device'], time.monotonic() - t0))
        if ready['device'] != 'cuda':
            fail('the service runs on %r, not the card' % ready['device'])
        client = ServiceClient('localhost', ready['port'], timeout=120,
                               name='chip_smoke')
        # the service process starts with every kernel count at 0; read
        # them just before the games drive the main path ...
        before = client.status()['kernel_launches']
        if any(before.values()):
            fail('kernel counts before the main path are not 0: %s' % before)
        t0 = time.monotonic()
        games, first_obs, ply_s = play_games(client, make_env, sample_seed,
                                             np)
        played_s = time.monotonic() - t0
        # ... and just after
        status = client.status()
        launches = status['kernel_launches']
        # the first ply also admits the model to the engine's vault
        steady = np.sort(np.asarray(ply_s[1:]))
        log('service: %d games, %d plies in %.2f s; %d requests in %d '
            'batches; kernel launches %s' % (
                games, len(ply_s), played_s, status['engine_requests'],
                status['engine_batches'], launches))
        log('service: ply round trip (4 geese) first %.2f ms; then p50 %.3f '
            'ms, p99 %.3f ms, mean %.3f ms over %d plies (host clock)' % (
                1e3 * ply_s[0], 1e3 * steady[len(steady) // 2],
                1e3 * steady[min(len(steady) - 1,
                                 int(0.99 * len(steady)))],
                1e3 * steady.mean(), len(steady)))
        if not launches.get('geese_trunk', 0) > 0:
            fail('the main path never launched geese_trunk: %s' % launches)
        if status['answered'] != status['received']:
            fail('unanswered requests: %s' % status)

        # one served policy against a local 'pad' forward of the same
        # weights (cuDNN convs, TF32 off)
        served = client.request('default@champion', first_obs)['outputs']
        pad = GeeseNet(filters=WIDTH['filters'], layers=WIDTH['layers'],
                       torus_impl='pad')
        pad.load_state_dict(net.state_dict())
        local = ModelWrapper(pad, device='cuda').inference(first_obs)
        policy_err = float(np.abs(np.asarray(served['policy'])
                                  - local['policy']).max())
        value_err = float(np.abs(np.asarray(served['value'])
                                 - local['value']).max())
        log('service: served policy vs local pad forward: max abs err '
            'policy %.3g value %.3g (tol %.0e)' % (policy_err, value_err,
                                                  POLICY_TOL))
        if not (policy_err <= POLICY_TOL and value_err <= POLICY_TOL):
            fail('served outputs disagree with the local forward')
        client.close()
        client = None

        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail('the service did not exit within 120 s of SIGTERM')
        log('service: exit %d after SIGTERM' % rc)
        if rc != 75:
            fail('the service exited %d after SIGTERM, expected 75' % rc)
        return launches
    except BaseException:
        if log_file is not None:
            log_file.flush()
            with open(os.path.join(tmp, 'service.log'), 'rb') as f:
                tail = f.read()[-4000:].decode('utf-8', 'replace')
            print('--- service log tail ---\n%s' % tail, file=sys.stderr)
        raise
    finally:
        if client is not None:
            client.close()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if log_file is not None:
            log_file.close()
        shutil.rmtree(tmp, ignore_errors=True)


def run_bench_entry(repo, compute_dtype='float32'):
    """``python -m handyrl_tpu_torch.bench --device cuda [--compute-dtype
    bfloat16]``: its one JSON line, checked: finite losses, both forms
    timed, the dtype that ran, and K1, K2 (the bf16 forms in bf16) and K3
    launched once a step in each form (the graphed form's steps include
    the eager warm-up steps of its capture) and the other form's trunk
    kernels never."""
    import math
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.bench', '--device', 'cuda',
         '--compute-dtype', compute_dtype],
        cwd=repo, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail('the bench entry exited %d:\n%s' % (proc.returncode,
                                                 proc.stderr[-4000:]))
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    if len(lines) != 1:
        fail('the bench entry printed %d JSON lines' % len(lines))
    line = json.loads(lines[0])
    launches, steps = line['kernel_launches'], line['steps_run']
    log('bench: graphed step %.3f ms (%.1f trajectories/s), eager step %.3f '
        'ms, over %d timed steps each (host clock, %s, %s); the graphed '
        'form\'s first call (%d eager warm-up steps and the capture) %.1f ms; '
        'peak memory %s MiB; %.1f s in all; losses %s; grad norm %.4g; '
        'steps %s; kernel launches %s' % (
            line['step_ms'], line['value'], line['eager_step_ms'],
            line['timed_steps'], line['device'], line['compute_dtype'],
            line['steps_by_form']['graphed']['capture_warmup'],
            line['graph_first_call_ms'], line['peak_memory_mib'],
            time.monotonic() - t0, line['losses'], line['grad_norm'],
            line['steps_by_form'], line['kernel_launches_by_form']))
    if line['form'] != 'graphed' or not line['eager_step_ms'] > 0:
        fail('the bench entry did not time both forms: %s' % line)
    if not all(math.isfinite(v) for v in line['losses'].values()):
        fail('the bench entry reports non-finite losses: %s' % line['losses'])
    if line['nonfinite'] != 0:
        fail('the bench entry hit the non-finite guard')
    if line['compute_dtype'] != compute_dtype:
        fail('the bench entry ran %s, not %s' % (line['compute_dtype'],
                                                  compute_dtype))
    trunk = ('geese_trunk', 'geese_trunk_bwd')
    bf16 = tuple(k + '_bf16' for k in trunk)
    want, never = ((bf16, trunk) if compute_dtype == 'bfloat16'
                   else (trunk, bf16))
    for form, counts in line['kernel_launches_by_form'].items():
        run = line['steps_by_form'][form]['run']
        for name in want + ('td_lambda',):
            if counts[name] != run:
                fail('the bench entry\'s %s form launched %s %d times in %d '
                     'steps' % (form, name, counts[name], run))
        for name in never:
            if counts[name]:
                fail('the bench entry\'s %s %s form launched %s'
                     % (compute_dtype, form, name))
    if sum(line['steps_by_form'][f]['run'] for f in ('eager', 'graphed')) \
            != steps:
        fail('the bench entry\'s steps do not add up: %s' % line)
    return line


def card_steps(torch, device, policy_target, value_target, obs, lrs,
               graphed=False, compute_dtype='float32'):
    """Headline update steps at B=STEP_B on ``device``, one for each lr in
    ``lrs`` (floats; NaN drives the guard), from the seeded weights and
    batch of the bench entry with ``obs`` (B, T, 1, 17, 7, 11) for its
    observations; eager (``build_update_step``) or, with ``graphed``, as
    the CUDA graph (``build_graphed_update_step``); the net in
    ``compute_dtype``. Returns the params before the first step and, after
    each step, a dict of the params, Adam's moments (mu, nu) and count,
    steps and the metrics, on the CPU."""
    from handyrl_tpu_torch import bench
    from handyrl_tpu_torch.ops.train_step import (build_graphed_update_step,
                                                  build_update_step)
    net, cfg, batch, state = bench.headline_setup(
        device, B=STEP_B, policy_target=policy_target,
        value_target=value_target, compute_dtype=compute_dtype)
    batch['observation'] = torch.from_numpy(obs).to(device)

    def cpu(d):
        return {k: v.detach().cpu().clone() for k, v in d.items()}
    before = cpu(state.params)
    if graphed:
        step = build_graphed_update_step(net, cfg, state)
    else:
        update = build_update_step(net, cfg)
    after = []
    for lr in lrs:
        lr = torch.tensor(lr, device=device)
        if graphed:
            metrics = step(batch, lr)
            state = step.state
        else:
            state, metrics = update(state, batch, lr)
        after.append({'params': cpu(state.params),
                      'mu': cpu(state.opt_state.mu),
                      'nu': cpu(state.opt_state.nu),
                      'count': int(state.opt_state.count),
                      'steps': int(state.steps),
                      'metrics': {k: float(v) for k, v in metrics.items()}})
    return before, after


def check_against_cpu(label, old, card, cpu, lr=None):
    """One update step on the card (``card``, from params ``old``) against
    the same step on the CPU, under the STEP_* tolerances (the params' at
    2 lr; lr defaults to the bench's)."""
    from handyrl_tpu_torch.bench import LR
    LR = LR if lr is None else lr
    m, cm = card['metrics'], cpu['metrics']
    new, cpu_new, mu, cpu_mu = (card['params'], cpu['params'], card['mu'],
                                cpu['mu'])
    terms = ('total', 'p', 'v', 'ent', 'diag_grad_norm', 'data_count')
    scale = max(abs(cm['total']), abs(cm['v']), 1.0)
    errs = {k: abs(m[k] - cm[k]) / scale / STEP_RTOL
            for k in ('total', 'p', 'v', 'ent')}
    errs['diag_grad_norm'] = (abs(m['diag_grad_norm'] - cm['diag_grad_norm'])
                              / max(cm['diag_grad_norm'], 1e-30)
                              / STEP_NORM_RTOL)
    errs['data_count'] = abs(m['data_count'] - cm['data_count'])
    step_max = max((new[k] - cpu_new[k]).abs().max().item() for k in new)
    diff = sum(((new[k] - cpu_new[k]) ** 2).sum().item() for k in new)
    upd = sum(((cpu_new[k] - old[k]) ** 2).sum().item() for k in new)
    update_rel = (diff / upd) ** 0.5
    mu_rel = {k: ((mu[k] - cpu_mu[k]).abs().max()
                  / cpu_mu[k].abs().max().clamp_min(1e-30)).item()
              for k in mu}
    mu_worst = sorted(mu_rel.items(), key=lambda kv: -kv[1])
    log('%s card vs CPU: %s; params max abs diff %.3g (tol 2 lr = %.0e), '
        'update L2 rel diff %.3g (tol %.0e); nonfinite %g' % (
            label, ', '.join('%s %.6g/%.6g' % (k, m[k], cm[k])
                             for k in terms),
            step_max, 2 * LR, update_rel, STEP_UPDATE_RTOL, m['nonfinite']))
    log('%s card vs CPU: Adam mu max abs diff / max |mu| by leaf, worst '
        'first (tol %.0e): %s' % (label, STEP_MU_RTOL, ', '.join(
            '%s %.3g' % kv for kv in mu_worst)))
    if m['nonfinite'] or cm['nonfinite']:
        fail('the %s step hit the non-finite guard' % label)
    bad = [k for k, e in errs.items() if not e <= 1]
    if bad:
        fail('the %s step on the card disagrees with the CPU in %s'
             % (label, bad))
    if not (step_max <= 2 * LR and update_rel <= STEP_UPDATE_RTOL):
        fail('the %s step on the card moves the params unlike the CPU'
             % label)
    if not mu_worst[0][1] <= STEP_MU_RTOL:
        fail('the %s step on the card gives Adam moments unlike the CPU in %s'
             % (label, [k for k, e in mu_worst if not e <= STEP_MU_RTOL]))
    if not cm['diag_grad_norm'] > 0:
        fail('the %s step has no gradient to compare' % label)


def check_graphed_against_eager(label, graphed, eager):
    """The graphed steps against the eager ones, step by step: count and
    steps equal, the rest within the GRAPH_* tolerances (see above);
    returns the largest differences seen."""
    worst = {'params': 0.0, 'moments': 0.0, 'metrics': 0.0}
    for i, (g, e) in enumerate(zip(graphed, eager)):
        if (g['count'], g['steps']) != (e['count'], e['steps']):
            fail('%s step %d: graphed count/steps %s, eager %s' % (
                label, i, (g['count'], g['steps']), (e['count'], e['steps'])))
        worst['params'] = max([worst['params']] + [
            (g['params'][k] - e['params'][k]).abs().max().item()
            for k in e['params']])
        worst['moments'] = max([worst['moments']] + [
            ((g[m][k] - e[m][k]).abs().max()
             / e[m][k].abs().max().clamp_min(1e-30)).item()
            for m in ('mu', 'nu') for k in e[m]])
        worst['metrics'] = max([worst['metrics']] + [
            abs(g['metrics'][k] - e['metrics'][k])
            / max(abs(e['metrics'][k]), 1.0) for k in e['metrics']])
        if set(g['metrics']) != set(e['metrics']):
            fail('%s: the graphed step reports other metrics' % label)
    equal = all(all(torch_equal(g[m], e[m]) for m in ('params', 'mu', 'nu'))
                and g['metrics'] == e['metrics']
                for g, e in zip(graphed, eager))
    log('%s: graphed vs eager over %d steps on the card: %s; params max abs '
        'diff %.3g (tol %.0e), mu/nu max diff / max |leaf| %.3g (tol %.0e), '
        'metrics max rel diff %.3g (tol %.0e)' % (
            label, len(eager), 'equal bit for bit' if equal else 'not equal',
            worst['params'], GRAPH_PARAM_ATOL, worst['moments'],
            GRAPH_MOMENT_RTOL, worst['metrics'], GRAPH_METRIC_RTOL))
    if not (worst['params'] <= GRAPH_PARAM_ATOL
            and worst['moments'] <= GRAPH_MOMENT_RTOL
            and worst['metrics'] <= GRAPH_METRIC_RTOL):
        fail('%s: the graphed step disagrees with the eager step' % label)
    return dict(worst, equal=equal)


def torch_equal(a, b):
    return all(bool((a[k] == b[k]).all()) for k in a)


def check_guard(label, good, nan, after):
    """A graphed step with a NaN lr (``nan``, after ``good``) keeps params,
    moments and count, reports nonfinite 1 and advances steps; the next
    step (``after``) with a finite lr trains."""
    kept = (torch_equal(nan['params'], good['params'])
            and torch_equal(nan['mu'], good['mu'])
            and torch_equal(nan['nu'], good['nu'])
            and nan['count'] == good['count'])
    trained = (not any(bool((after['params'][k] == nan['params'][k]).all())
                       for k in nan['params'])
               and after['count'] == nan['count'] + 1
               and after['metrics']['nonfinite'] == 0)
    log('%s: graphed step with lr NaN: state kept %s, nonfinite %g, steps '
        '%d -> %d; the next step with a finite lr trains: %s (count %d -> '
        '%d)' % (label, kept, nan['metrics']['nonfinite'], good['steps'],
                 nan['steps'], trained, nan['count'], after['count']))
    if not (kept and nan['metrics']['nonfinite'] == 1
            and nan['steps'] == good['steps'] + 1 and trained):
        fail('%s: the non-finite guard in the graph misbehaves' % label)


def phase_training(torch, repo, make_env):
    import numpy as np
    from handyrl_tpu_torch.bench import LR
    from handyrl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    out = {'bench': run_bench_entry(repo), 'paths': {}}
    out['paths']['bench'] = out['bench']['kernel_launches']
    # the bench's uniform-noise planes saturate the full-width net (tanh
    # values of exactly +-1, logits in the hundreds: every grad is 0), so
    # the card-vs-CPU step runs on real boards, where the grads are not
    obs = np.stack(game_observations(make_env, STEP_B * 16, SEED + 4))
    obs = obs.reshape(STEP_B, 16, 1, 17, 7, 11)
    nan = float('nan')
    for pt, vt, path in (('TD', 'TD', ('geese_trunk', 'geese_trunk_bwd',
                                        'td_lambda')),
                         ('UPGO', 'VTRACE', ('geese_trunk', 'geese_trunk_bwd',
                                             'upgo', 'vtrace'))):
        label = '%s/%s B=%d' % (pt, vt, STEP_B)
        _, cpu = card_steps(torch, 'cpu', pt, vt, obs, (LR,))
        runs = {}
        for form, lrs in (('eager', (LR,) * 3),
                          ('graphed', (LR,) * 3 + (nan, LR))):
            reset_kernel_launches()
            runs[form] = card_steps(torch, 'cuda', pt, vt, obs, lrs,
                                    graphed=form == 'graphed')
            torch.cuda.synchronize()
            launches = kernel_launches()
            out['paths']['%s_%s_%s' % (form, pt, vt)] = launches
            log('step %s %s on the card: %d steps, kernel launches %s' % (
                label, form, len(lrs), launches))
            missing = [k for k in path if launches[k] < 1]
            if missing:
                fail('the %s %s step never launched %s' % (label, form,
                                                           missing))
            old, after = runs[form]
            check_against_cpu('step %s %s' % (label, form), old, after[0],
                              cpu[0])
        graphed = runs['graphed'][1]
        out[(pt, vt)] = check_graphed_against_eager(
            'step ' + label, graphed[:3], runs['eager'][1])
        check_guard('step ' + label, graphed[2], graphed[3], graphed[4])
    out['profile'] = {form: profile_step(torch, form)
                      for form in ('eager', 'graphed')}
    return out


# the kernels that must show once a step in the profiled window, by the
# name the profiler gives them
PROFILED = ('trunk_fwd_kernel', 'trunk_bwd_kernel', 'trunk_wgrad_kernel',
            'lambda_kernel')


def profile_step(torch, form, steps=5):
    """Device time by kernel over ``steps`` headline update steps (B=128,
    T=16) of ``form`` ('eager' or 'graphed': replays of the step's CUDA
    graph) under torch.profiler, and the device's busy share of the window
    (the profiler's own host cost lengthens the window, so the idle share
    is an upper bound). One step under the profiler's warm-up comes first
    and is not recorded: without it the trace missed the window's first
    kernel launches (it listed K1 with 4 of its 5). Fails unless each of
    PROFILED shows once a step in the device rows (of a second window when
    the first lost a record): for the graphed form that is the proof that
    replays run the kernels."""
    from handyrl_tpu_torch import bench
    from handyrl_tpu_torch.ops.train_step import (build_graphed_update_step,
                                                  build_update_step)
    net, cfg, batch, state = bench.headline_setup('cuda')
    lr = torch.tensor(bench.LR, device='cuda')
    if form == 'graphed':
        graphed = build_graphed_update_step(net, cfg, state)

        def step():
            graphed(batch, lr)
    else:
        update = build_update_step(net, cfg)
        holder = [state]

        def step():
            holder[0], _ = update(holder[0], batch, lr)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    result = profile_window(torch, form, step, steps)
    if result is None:
        # a window can lose a record: of 8 windows profiled on an H100, one
        # (of the eager step) listed K1 4 times in 5 steps while the
        # wrapper counted 5. A second window must show each kernel once a
        # step.
        log('profile %s: a second window' % form)
        result = profile_window(torch, form, step, steps)
    if result is None:
        fail('profile %s: kernels not once a step in the device rows of two '
             'windows of %d steps' % (form, steps))
    return result


def profile_window(torch, form, step, steps):
    """One profiled window of ``steps`` calls of ``step``: the summary, or
    None when a kernel of PROFILED is not in it once a step."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        step()   # the warm-up step
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(steps):
            step()
            if i == steps - 1:
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
            prof.step()   # the last one closes the recorded window

    # the kernels' own rows (the host ops' rows repeat their kernels' time,
    # and so does the schedule's ProfilerStep row)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    if not events:
        fail('profile %s: the profiler shows no kernel on the card (CUPTI '
             'saw no device activity)' % form)
    rows = sorted(((device_us(e) / 1e3 / steps, e.count / steps, e.key)
                   for e in events if not e.key.startswith('ProfilerStep')),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    step_ms = wall_ms / steps
    launches = sum(r[1] for r in rows)
    log('profile %s: %d steps, %.3f ms a step on the host clock (profiled), '
        'device busy %.3f ms a step (%.1f%%, idle %.1f%%), %g kernel '
        'launches a step of %d kernels' % (
            form, steps, step_ms, busy, 100 * busy / step_ms,
            100 - 100 * busy / step_ms, launches, len(rows)))
    for ms, count, key in rows[:10]:
        log('  %8.4f ms a step  %6.2f launches a step  %s' % (ms, count,
                                                               key[:90]))
    counts = {name: sum(e.count for e in events
                        if re.search(r'\b%s[<(]' % name, e.key))
              for name in PROFILED}
    log('profile %s: launches in the window of %d steps: %s' % (
        form, steps, counts))
    if any(c != steps for c in counts.values()):
        return None
    return {'step_ms_profiled': step_ms, 'device_busy_ms': busy,
            'idle_share': 1 - busy / step_ms,
            'launches_per_step': launches, 'launches_in_window': counts,
            'top': [{'kernel': k[:120], 'ms_per_step': ms,
                     'launches_per_step': c} for ms, c, k in rows[:10]]}


# the learner phase's config: the update step of the bench (B=128, T=16,
# TD/TD, gamma 0.99, solo training with observations) fed by batched
# self-play of 64 Hungry Geese envs on the full-width GeeseNet's kernels
LEARNER_EPOCHS = 2       # 3 until phase 16 needed the time (PERF.md §4)
LEARNER_CONFIG = {
    'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
    'train_args': {
        'turn_based_training': False, 'observation': True, 'gamma': 0.99,
        'forward_steps': 16, 'compress_steps': 4, 'batch_size': 128,
        'policy_target': 'TD', 'value_target': 'TD',
        'generation_envs': 64, 'num_batchers': 2,
        'minimum_episodes': 256, 'update_episodes': 512,
        'epochs': LEARNER_EPOCHS, 'eval': {'opponent': ['random']},
        'seed': SEED},
}
LEARNER_FILES = ['%d.ckpt' % e for e in range(1, LEARNER_EPOCHS + 1)] + [
    'latest.ckpt', 'trainer_state.ckpt']


# phase 5(b): the same run with its batches built in spawned processes
# into shared-memory slots
BATCHER_SWITCHES = {'batcher_processes': True, 'batcher_shared_memory': True}


def shm_listing():
    """The names in /dev/shm (where POSIX shared memory lives on Linux)."""
    return set(os.listdir('/dev/shm'))


def run_learner_entry(repo, tmp, extra=None, device_flag=True):
    """``python -m handyrl_tpu_torch.train --config ... [--device cuda]`` on
    LEARNER_CONFIG with ``extra`` train_args: its JSON line and the wall
    time of the process."""
    cfg = json.loads(json.dumps(LEARNER_CONFIG))
    cfg['train_args'].update(extra or {})
    cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
    path = os.path.join(tmp, 'learner.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             path] + (['--device', 'cuda'] if device_flag else []),
            cwd=repo, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as exc:
        fail('the learner did not finish within 600 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(('epoch', 'win rate', 'generation stats', 'loss',
                            'updated model', 'batcher processes')):
            log('  learner: %s' % line)
    if proc.returncode != 0:
        fail('the learner exited %d:\n%s' % (proc.returncode,
                                             proc.stderr[-4000:]))
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    if len(lines) != 1:
        fail('the learner printed %d JSON lines' % len(lines))
    return json.loads(lines[0]), wall


def phase_learner(torch, repo, make_env, bench_line, extra=None,
                  device_flag=True):
    """Phase 5 (and 5(b) with ``extra``): the learner's run and its
    checks; returns its JSON line, with the process wall as 'wall'."""
    import math
    import numpy as np
    from handyrl_tpu_torch.evaluation import load_model
    from handyrl_tpu_torch.model import param_trees
    from handyrl_tpu_torch.ops.train_step import GRAPH_WARMUP_STEPS
    from handyrl_tpu_torch.utils import flax_msgpack
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    tmp = tempfile.mkdtemp(prefix='chip_smoke_learner_')
    try:
        line, wall = run_learner_entry(repo, tmp, extra, device_flag)
        line['wall'] = wall
        models = os.path.join(tmp, 'models')
        log('learner: %s' % json.dumps(line))
        if line['epochs'] != LEARNER_EPOCHS or line['failed']:
            fail('the learner trained %s epochs (failed %s)'
                 % (line['epochs'], line['failed_reason']))
        for name in LEARNER_FILES:
            ok, reason = verify_checkpoint(os.path.join(models, name))
            if not ok or reason != 'ok':
                fail('learner checkpoint %s: %s' % (name, reason))
        if not (line['losses'] and all(math.isfinite(v)
                                       for v in line['losses'].values())):
            fail('the learner reports non-finite losses: %s'
                 % line['losses'])
        env = make_env(LEARNER_CONFIG['env_args'])
        _, from_flax = param_trees(env.net())

        def params(name):
            with open(os.path.join(models, name), 'rb') as f:
                return from_flax(flax_msgpack.from_bytes(f.read()))
        first, last = params('1.ckpt'), params('%d.ckpt' % LEARNER_EPOCHS)
        moved = {k: (last[k] - first[k]).abs().max().item() for k in first}
        log('learner: params max abs change from 1.ckpt to %d.ckpt by leaf: '
            '%s' % (LEARNER_EPOCHS, ', '.join('%s %.3g' % kv
                                              for kv in moved.items())))
        if not any(v > 0 for v in moved.values()):
            fail('the learner\'s params did not change after epoch 1')
        by_path = line['kernel_launches']
        gen, ev = by_path.get('generation', {}), by_path.get('evaluation', {})
        train = by_path.get('training', {})
        runs = line['steps_at_exit'] + GRAPH_WARMUP_STEPS
        log('learner: kernel launches by path %s; %d update steps (and %d '
            'eager warm-up steps of the capture)' % (
                by_path, line['steps_at_exit'], GRAPH_WARMUP_STEPS))
        if not (gen.get('geese_trunk', 0) > 0 and ev.get('geese_trunk', 0) > 0):
            fail('the learner\'s generation or evaluation never launched K1')
        if any(p.get(k, 0) for p in (gen, ev)
               for k in ('geese_trunk_bwd', 'td_lambda', 'upgo', 'vtrace')):
            fail('generation or evaluation launched a training kernel')
        for name in ('geese_trunk', 'geese_trunk_bwd', 'td_lambda'):
            if train.get(name) != runs:
                fail('the learner\'s training launched %s %s times in %d '
                     'steps' % (name, train.get(name), runs))

        # latest.ckpt on the card against the CPU, on real boards
        obs = np.stack(game_observations(make_env, 64, SEED + 5))
        card = load_model(os.path.join(models, 'latest.ckpt'), env, 'cuda')
        cpu = load_model(os.path.join(models, 'latest.ckpt'), env, 'cpu')
        got, want = card.batch_inference(obs), cpu.batch_inference(obs)
        err = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
        log('learner: latest.ckpt forward on the card vs the CPU over %d '
            'real boards: max abs err %s (tol %.0e)' % (
                len(obs), err, POLICY_TOL))
        if not all(np.isfinite(got[k]).all() for k in got) or \
                max(err.values()) > POLICY_TOL:
            fail('the learner\'s checkpoint computes other outputs on the '
                 'card than on the CPU')
        log('learner: %.1f episodes/s generated, %.2f update steps/s, %.1f '
            'trajectories/s trained (bench graphed step alone: %.1f), epochs '
            '%s s, peak memory %.1f MiB, %.1f s process wall (%s)' % (
                line['episodes_per_s'], line['update_steps_per_s'],
                line['trajectories_per_s'], bench_line['value'],
                ['%.2f' % t for t in line['epoch_seconds']],
                line['peak_memory_mib'], wall, nvidia_smi_line()))
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# 9(b)'s learner: a torch.profiler trace of its second epoch (in a run
# whose rates are compared with no other: the profiler's cost and its
# export land in that epoch)
PROFILE_SWITCHES = {'profile_epochs': '2'}


def check_profile(label, line):
    """A run's ``profile_epochs`` trace: valid Chrome JSON with CUDA
    kernel events (torch.profiler's 'kernel' category). Returns the count
    of each kernel of PROFILED in it (graph replays included), which it
    logs; fails without a kernel event."""
    paths = (line.get('telemetry') or {}).get('profiles') or []
    if len(paths) != 1:
        fail('%s wrote %d profiler traces, 1 expected' % (label, len(paths)))
    t0 = time.monotonic()
    try:
        with open(paths[0]) as f:
            doc = json.load(f)
    except ValueError as exc:
        fail('%s: the profiler trace is not valid JSON (%s)' % (label, exc))
    events = doc.get('traceEvents') or []
    kernels = [e for e in events if e.get('cat') == 'kernel']
    if not kernels:
        fail('%s: the profiler trace holds no CUDA kernel event (%d events)'
             % (label, len(events)))
    seen = {k: sum(1 for e in kernels if k in e.get('name', ''))
            for k in PROFILED}
    log('%s: profile of epoch 2 (%s, %.1f MB, read in %.2f s): %d events, '
        '%d CUDA kernels; of the graphed step\'s kernels %s appear (%s), '
        'missing: %s' % (
            label, os.path.basename(paths[0]),
            os.path.getsize(paths[0]) / 1e6, time.monotonic() - t0,
            len(events), len(kernels),
            [k for k in PROFILED if seen[k]],
            ', '.join('%s %d' % kv for kv in seen.items()),
            [k for k in PROFILED if not seen[k]] or 'none'))
    return seen


def check_shm_run(label, line, before, after):
    """A learner run with BATCHER_SWITCHES took the shared-memory path
    (its JSON line's 'batcher_mode' and 'shm': batches mapped, slots used,
    segment names) and left no segment in /dev/shm (listings ``before``
    and ``after`` the process)."""
    shm = line.get('shm') or {}
    left = sorted(set(shm.get('segments', [])) & after)
    new = sorted(after - before)
    log('%s: batcher mode %s; %d batches through %d shared-memory slots '
        '(%d a batcher) in segments %s; /dev/shm after the run: %d names, '
        'new %s, of the run %s' % (
            label, line.get('batcher_mode'), shm.get('batches', 0),
            shm.get('slots_used', 0), shm.get('slots_per_batcher', 0),
            shm.get('segments'), len(after), new, left))
    if line.get('batcher_mode') != 'shared_memory' or not (
            shm.get('batches', 0) > 0 and shm.get('slots_used', 0) > 0
            and shm.get('segments')):
        fail('%s did not take the shared-memory batcher path: %s'
             % (label, shm))
    if left or new:
        fail('%s left shared-memory segments behind: %s' % (label,
                                                             left or new))


def side_by_side(label, names, lines):
    """The rates of runs of one config, one column a run."""
    keys = ('episodes_per_s', 'trajectories_per_s', 'update_steps_per_s',
            'trainer_batch_wait_seconds', 'train_seconds', 'wall')
    log('%s, same card (%s):' % (label, nvidia_smi_line()))
    log('  %-28s %s' % ('', ' '.join('%16s' % n for n in names)))
    for k in keys:
        log('  %-28s %s' % (k, ' '.join(
            '%16.3f' % l[k] if l.get(k) is not None else '%16s' % '-'
            for l in lines)))
    stages = sorted(set().union(*(l['loop_seconds'] for l in lines)))
    for k in stages:
        log('  %-28s %s' % ('loop_seconds.' + k, ' '.join(
            '%16.3f' % l['loop_seconds'].get(k, 0.0) for l in lines)))


def phase_learner_shm(torch, repo, make_env, bench_line, threaded):
    """Phase 5(b): phase 5's run with BATCHER_SWITCHES and no --device,
    its checks, the shared-memory path and /dev/shm; the two runs side by
    side."""
    before = shm_listing()
    line = phase_learner(torch, repo, make_env, bench_line,
                         extra=BATCHER_SWITCHES,
                         device_flag=False)
    check_shm_run('learner (shm)', line, before, shm_listing())
    side_by_side('host learner, batcher threads vs processes with '
                 'shared-memory batches', ('threads', 'shm processes'),
                 (threaded, line))
    return line


# ---------------------------------------------------- phase 6: fused loop

# the fused device loop at the JAX package's north-star configuration
# (scripts/run_north_star.py:36-50): full-width GeeseNet, B=64, T=16,
# VTRACE/VTRACE, 64 generation envs, 32-ply chunks, 32 eval envs, 64 SGD
# steps a chunk; 200 episodes before the first epoch and 100 an epoch,
# checkpoint files every 10 epochs and at the last, a metrics row an epoch
FUSED_EPOCHS = 120       # 170 until phase 19 needed the time (PERF.md §4)
FUSED_K = 64
FUSED_INTERVAL = 10
FUSED_CONFIG = {
    'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
    'train_args': {
        'turn_based_training': False, 'observation': True, 'gamma': 0.99,
        'forward_steps': 16, 'batch_size': 64,
        'policy_target': 'VTRACE', 'value_target': 'VTRACE',
        'generation_envs': 64, 'device_generation': True,
        'device_replay': True, 'device_chunk_steps': 32, 'eval_envs': 32,
        'sgd_steps_per_chunk': FUSED_K, 'minimum_episodes': 200,
        'update_episodes': 100, 'epochs': FUSED_EPOCHS,
        'checkpoint_interval': FUSED_INTERVAL,
        'eval': {'opponent': ['random']},
        'seed': SEED},
}
FUSED_PATHS = {'generation': ('geese_trunk',),
               'evaluation': ('geese_trunk',),
               'training': ('geese_trunk', 'geese_trunk_bwd', 'vtrace')}
FUSED_PROFILED = {'trunk_fwd_kernel': 'chunk + K', 'trunk_bwd_kernel': 'K',
                  'trunk_wgrad_kernel': 'K', 'vtrace_kernel': 'K'}
# every fused metrics row (handyrl_tpu/train.py:2378-2496, without the
# planes the port lacks), and the keys of rows of epochs that had results
METRICS_KEYS = ('epoch', 'steps', 'episodes', 'time', 'run_id', 'telemetry',
                'sgd_steps_per_sec', 'buffer', 'replay_dropped_episodes',
                'replay_ring_occupancy', 'replay_sample_reuse',
                'guard_nonfinite', 'guard_rollbacks', 'guard_bad_episodes',
                'dispatches_gen', 'dispatches_eval')
METRICS_SOME_KEYS = ('generation_mean', 'win_rate', 'eval_opponents',
                     'win_rate_recent10', 'eval_games_recent10')
INGEST_PLIES = 64        # the card-vs-CPU ingest: two chunks' plies
INGEST_CAPACITY = 32     # into a ring that they wrap


def run_fused_entry(repo, tmp):
    """``python -m handyrl_tpu_torch.train --config ...`` (no --device: the
    card is the default) on FUSED_CONFIG, its rows to ``metrics.jsonl``:
    its JSON line and its wall."""
    cfg = json.loads(json.dumps(FUSED_CONFIG))
    cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
    cfg['train_args']['metrics_jsonl'] = os.path.join(tmp, 'metrics.jsonl')
    path = os.path.join(tmp, 'fused.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             path], cwd=repo, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as exc:
        fail('the fused learner did not finish within 600 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    out = proc.stdout.splitlines()
    if 'fused device pipeline' not in proc.stdout or \
            '(solo mode)' not in proc.stdout:
        fail('the learner did not run the fused device pipeline:\n%s'
             % proc.stdout[-2000:])
    epochs = [i for i, l in enumerate(out) if l.startswith('epoch ')]
    for i in epochs[:2] + epochs[-2:]:
        for line in out[i:i + 5]:
            if line.startswith(('epoch', 'win rate', 'generation stats',
                                'loss', 'updated model')):
                log('  fused: %s' % line)
    if proc.returncode != 0:
        fail('the fused learner exited %d:\n%s' % (proc.returncode,
                                                   proc.stderr[-4000:]))
    lines = [l for l in out if l.startswith('{')]
    if len(lines) != 1:
        fail('the fused learner printed %d JSON lines' % len(lines))
    return json.loads(lines[0]), wall


def fused_env_checks(torch):
    """The env twin's step, observe, greedy agent and auto-reset on the card
    against the CPU, on a state reached by 40 random plies of 64 games,
    with the same actions and uniforms: equal exactly, every field."""
    from handyrl_tpu_torch.envs import torch_hungry_geese as tg
    gen = torch.Generator().manual_seed(SEED + 11)
    state = tg.init_state(64, generator=gen)
    for _ in range(40):
        acts = torch.randint(0, 4, (64, 4), generator=gen)
        state = tg.step(state, acts, generator=gen)
        state = tg.auto_reset(state, tg.terminal(state), generator=gen)
    acts = torch.randint(0, 4, (64, 4), generator=gen)
    u_food = torch.rand((64, tg.N_FOOD), generator=gen)
    u_greedy = torch.rand((64, 4), generator=gen)
    u_reset = torch.rand((64, tg.N_CELLS), generator=gen)

    def run(dev):
        st = tg.State(*[t.to(dev) for t in state])
        nxt = tg.step(st, acts.to(dev), u=u_food.to(dev))
        out = {'step.' + k: v for k, v in nxt._asdict().items()}
        done = tg.terminal(nxt)
        reset = tg.auto_reset(nxt, done, u=u_reset.to(dev))
        out.update({'reset.' + k: v for k, v in reset._asdict().items()})
        out['observe'] = tg.observe(st)
        out['greedy'] = tg.greedy_action(st, u=u_greedy.to(dev))
        out['outcome'] = tg.outcome(nxt)
        out['terminal'] = done
        return {k: v.cpu() for k, v in out.items()}

    card, cpu = run('cuda'), run('cpu')
    bad = [k for k in cpu if not torch.equal(card[k], cpu[k])]
    log('fused: env step/auto_reset/observe/greedy_action/outcome on the '
        'card vs the CPU, 64 games after 40 plies: %d fields, unequal %s'
        % (len(cpu), bad))
    if bad:
        fail('the env twin computes other values on the card than on the '
             'CPU in %s' % bad)


def fused_setup(torch, capacity=None):
    """An in-process fused pipeline at FUSED_CONFIG's widths on the card:
    (pipeline, update step, env module, args)."""
    from handyrl_tpu_torch.config import apply_defaults
    from handyrl_tpu_torch.envs import torch_hungry_geese as tg
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.ops.device_windows import DeviceWindower
    from handyrl_tpu_torch.ops.fused_pipeline import FusedPipeline
    from handyrl_tpu_torch.ops.replay import (
        resolve_windows_per_episode, ring_capacity, windows_per_episode)
    from handyrl_tpu_torch.ops.train_step import ReplayUpdateStep, \
        init_train_state
    from handyrl_tpu_torch.train import loss_config
    args = apply_defaults(FUSED_CONFIG)['train_args']
    resolve_windows_per_episode(args, tg)    # as the learner sizes it
    net = GeeseNet(torus_impl='pallas',
                   generator=torch.Generator().manual_seed(SEED)).cuda()
    actor = GeeseNet(torus_impl='pallas').cuda()
    actor.load_state_dict(net.state_dict())
    step = ReplayUpdateStep(net, loss_config(args), init_train_state(net))
    windower = DeviceWindower(
        'solo', args['forward_steps'], 0, tg.MAX_STEPS,
        windows_per_episode(args), capacity or ring_capacity(args), 4,
        args['gamma'], False)
    fp = FusedPipeline(tg, actor, step, windower, args['generation_envs'],
                       args['device_chunk_steps'], FUSED_K,
                       args['batch_size'], seed=SEED)
    return fp, step, tg, args


def fused_ingest_and_step_checks(torch, fp, tg, args, mode='solo',
                                 make_net=None, cfg=None):
    """Records of INGEST_PLIES plies on the card, ingested on the card and
    on the CPU with the same draws into a ring of INGEST_CAPACITY rows: history, counts,
    ring rows, cursor and size equal exactly. Then three steps of the
    card's step graph (its first eager, then a capture and a replay) on
    that ring, each held against the CPU's step from the card's state with
    the slots the card drew, under phase 4's tolerances; the slots of two
    replays must differ. ``mode`` is the windower's layout, ``make_net(
    seed)`` a CPU net of the pipeline's architecture (the full-width
    GeeseNet by default) and ``cfg`` the step's loss config (the args')."""
    from handyrl_tpu_torch.ops.device_windows import DeviceWindower
    from handyrl_tpu_torch.ops.train_step import ReplayUpdateStep, \
        TrainState, AdamState
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.train import loss_config
    if make_net is None:
        def make_net(seed):
            return GeeseNet(torus_impl='pallas', generator=(
                None if seed is None else torch.Generator().manual_seed(seed)))
    P = tg.NUM_PLAYERS
    state = tg.State(*[t.clone() for t in fp.state])
    _, records, _ = fp._rollout(state, INGEST_PLIES,
                                torch.Generator('cuda').manual_seed(SEED + 3))
    K, N = records['done'].shape
    W = fp.windower.W
    gen = torch.Generator().manual_seed(SEED + 12)
    draws = {'u': torch.rand((K, N, W), generator=gen),
             'seat': torch.randint(0, P, (K, N, W), generator=gen)}
    out = {}
    for dev in ('cuda', 'cpu'):
        wd = DeviceWindower(mode, args['forward_steps'], 0, tg.MAX_STEPS,
                            W, INGEST_CAPACITY, P, args['gamma'], False)
        rec = {k: v.to(dev) for k, v in records.items()}
        ws = wd.init_state(rec)
        ring = wd.init_ring(rec)
        cursor = torch.zeros((), dtype=torch.int64, device=dev)
        size = torch.zeros((), dtype=torch.int64, device=dev)
        n_done, n_win = wd.ingest(rec, ws, ring, cursor, size,
                                  draws={k: v.to(dev)
                                         for k, v in draws.items()})
        out[dev] = dict(ring=ring, cursor=cursor, size=size, ws=ws,
                        n_done=int(n_done), n_win=int(n_win), wd=wd)
    c, h = out['cuda'], out['cpu']
    bad = [k for k in h['ring'] if not torch.equal(
        c['ring'][k][:INGEST_CAPACITY].cpu(), h['ring'][k][:INGEST_CAPACITY])]
    bad += [k for k in h['ws']['hist'] if not torch.equal(
        c['ws']['hist'][k].cpu(), h['ws']['hist'][k])]
    for k in ('cursor', 'size'):
        if int(c[k]) != int(h[k]):
            bad.append(k)
    if not torch.equal(c['ws']['counts'].cpu(), h['ws']['counts']):
        bad.append('counts')
    log('fused: %s ingest of %d plies of %d envs on the card vs the CPU: '
        '%d episodes, %d windows into %d rows (cursor %d, size %d); unequal '
        '%s' % (mode, K, N, h['n_done'], h['n_win'], INGEST_CAPACITY,
                int(h['cursor']), int(h['size']), bad))
    if bad or (c['n_done'], c['n_win']) != (h['n_done'], h['n_win']):
        fail('the ingest on the card differs from the CPU\'s in %s' % bad)
    if h['n_win'] <= INGEST_CAPACITY:
        fail('the ingest check\'s ring did not wrap')

    cfg = cfg or loss_config(args)
    net = make_net(SEED + 1)
    from handyrl_tpu_torch.ops.train_step import init_train_state
    card = ReplayUpdateStep(net.cuda(), cfg, init_train_state(net.cuda()))
    host_net = make_net(None)
    host = ReplayUpdateStep(host_net, cfg, init_train_state(host_net))
    card.bind(c['ring'], c['wd'].window_spec, c['size'], c['cursor'],
              INGEST_CAPACITY, args['batch_size'],
              torch.Generator('cuda').manual_seed(SEED + 4))
    host.bind(h['ring'], h['wd'].window_spec, h['size'], h['cursor'],
              INGEST_CAPACITY, args['batch_size'], None)
    ema = float(args['batch_size'] * args['forward_steps'])
    lr = 3e-8 * ema

    def snap(st, metrics=None):
        return {'params': {k: v.detach().cpu().clone()
                           for k, v in st.state.params.items()},
                'mu': {k: v.cpu().clone()
                       for k, v in st.state.opt_state.mu.items()},
                'state': TrainState(
                    params={k: v.detach().cpu().clone()
                            for k, v in st.state.params.items()},
                    opt_state=AdamState(
                        count=st.state.opt_state.count.cpu().clone(),
                        mu={k: v.cpu().clone()
                            for k, v in st.state.opt_state.mu.items()},
                        nu={k: v.cpu().clone()
                            for k, v in st.state.opt_state.nu.items()}),
                    steps=st.state.steps.cpu().clone()),
                'metrics': metrics}

    slots_seen = []
    for i in range(3):
        before = snap(card)
        m = card.unpack(card.run(1, ema))
        torch.cuda.synchronize()
        slots = card.last_slots.cpu().clone()
        slots_seen.append(slots)
        host.load_state(before['state'])
        hm = host.unpack(host.run(1, ema, slots=slots[None]))
        after = snap(card, {k: float(v) for k, v in m.items()})
        cpu_after = snap(host, {k: float(v) for k, v in hm.items()})
        check_against_cpu('fused K-step update (%s), step %d (%s)' % (
            mode, i + 1, ('eager', 'captured and replayed', 'replayed')[i]),
            before['params'], after, cpu_after, lr=lr)
    if torch.equal(slots_seen[1], slots_seen[2]):
        fail('two replays of the step graph drew the same slots')
    log('fused: the step graph\'s replays drew different slots (%d of %d '
        'differ)' % (int((slots_seen[1] != slots_seen[2]).sum()),
                     slots_seen[1].numel()))


def fused_profile(torch, fp, args):
    """Replays of the chunk graph draw new actions; then one steady fused
    dispatch (chunk + ingest + K steps, graphs captured already) under
    torch.profiler: its device busy time, the host-clock dispatch, the
    idle share and the top kernels; each kernel of FUSED_PROFILED in the
    device rows as often as the dispatch launches it (of a second window
    when the first lost a record)."""
    for _ in range(2):   # the chunk graph: eager, then captured + replayed
        fp.warm_step()
    # two more warm-up dispatches: two replays of one graph
    fp.warm_step()
    a1 = fp._chunk._out['action'].clone()
    fp.warm_step()
    a2 = fp._chunk._out['action'].clone()
    differ = int((a1 != a2).sum())
    log('fused: two replays of the rollout graph: %d of %d actions differ'
        % (differ, a1.numel()))
    if differ == 0:
        fail('two replays of the rollout graph drew the same actions')
    ema = float(args['batch_size'] * args['forward_steps'])
    parts = dispatch_parts_ms(torch, fp, args, FUSED_K, 'fused')
    result = fused_profile_window(torch, fp, args, ema)
    if result is None:
        # a window can lose records, as phase 4's profile_step found: one of
        # three steady dispatches profiled on an H100 listed K2a and K2b 63
        # times in 64 steps. A second window must show every launch.
        log('fused profile: a second window')
        result = fused_profile_window(torch, fp, args, ema)
    if result is None:
        fail('the profiled fused dispatch did not launch the kernels as '
             'often as its graphs hold them, in two windows')
    result.update(chunk_ms=parts['chunk'], steps_ms=parts['steps'])
    return result


def dispatch_parts_ms(torch, fp, args, k, label):
    """A steady dispatch's two parts apart, by CUDA events over 3 calls
    each, after the step graph's eager call, capture and replay:
    {'chunk': ms a chunk graph, 'steps': ms of ``k`` step replays}."""
    ema = float(args['batch_size'] * args['forward_steps'])
    for _ in range(3):   # the step graph: eager, capture, replay
        fp.train_step(ema)
    torch.cuda.synchronize()
    parts = {}
    for name, fn in (('chunk', fp._chunk),
                     ('steps', lambda: fp.update_step.run(k, ema))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        parts[name] = start.elapsed_time(end) / 3
    log('%s: the chunk graph (%d plies of %d envs and their ingest) %.3f '
        'ms a call; %d replays of the step graph %.3f ms (%.4f ms a step); '
        'CUDA events' % (label, args['device_chunk_steps'],
                         args['generation_envs'], parts['chunk'], k,
                         parts['steps'], parts['steps'] / k))
    return parts


def fused_profile_window(torch, fp, args, ema):
    """One steady fused dispatch under torch.profiler: the summary, or None
    when a kernel of the dispatch is not in the device rows as often as its
    graphs launch it."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fp.train_step(ema)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    if not events:
        fail('fused profile: the profiler shows no kernel on the card')
    rows = sorted(((device_us(e) / 1e3, e.count, e.key) for e in events),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log('fused profile: one steady dispatch (%d plies of %d envs, ingest, %d '
        'SGD steps at B=%d): %.3f ms on the host clock (profiled), device '
        'busy %.3f ms (%.1f%%, idle %.1f%%), %d kernel launches of %d '
        'kernels' % (args['device_chunk_steps'], args['generation_envs'],
                     FUSED_K, args['batch_size'], wall_ms, busy,
                     100 * busy / wall_ms, 100 - 100 * busy / wall_ms,
                     sum(r[1] for r in rows), len(rows)))
    for ms, count, key in rows[:12]:
        log('  %9.4f ms  %6d launches  %s' % (ms, count, key[:90]))
    want = {'trunk_fwd_kernel': args['device_chunk_steps'] + FUSED_K,
            'trunk_bwd_kernel': FUSED_K, 'trunk_wgrad_kernel': FUSED_K,
            'vtrace_kernel': FUSED_K}
    counts = {name: sum(e.count for e in events
                        if re.search(r'\b%s[<(]' % name, e.key))
              for name in want}
    log('fused profile: launches in the dispatch %s (expected %s)'
        % (counts, want))
    if counts != want:
        return None
    return {'dispatch_ms_profiled': wall_ms, 'device_busy_ms': busy,
            'idle_share': 1 - busy / wall_ms,
            'launches': sum(r[1] for r in rows), 'kernels': len(rows),
            'launches_in_dispatch': counts,
            'top': [{'kernel': k[:120], 'ms': ms, 'launches': c}
                    for ms, c, k in rows[:12]]}


def read_metrics(path):
    rows = []
    with open(path) as f:
        for l in f:
            if l.strip():
                rows.append(json.loads(l))
    return rows


def check_metrics_rows(rows, epochs):
    """One row an epoch 1..epochs (none preempted), every row with
    METRICS_KEYS and a telemetry summary, each of METRICS_SOME_KEYS in
    some row, steps non-decreasing."""
    got = [r['epoch'] for r in rows]
    if got != list(range(1, epochs + 1)):
        fail('the fused metrics rows are for epochs %s' % got)
    for r in rows:
        missing = [k for k in METRICS_KEYS if k not in r]
        if missing or 'counters' not in r['telemetry'] or \
                r.get('preempted'):
            fail('fused metrics row of epoch %d lacks %s: %s'
                 % (r['epoch'], missing, json.dumps(r)[:400]))
    for k in METRICS_SOME_KEYS:
        if not any(k in r for r in rows):
            fail('no fused metrics row has %r' % k)
    steps = [r['steps'] for r in rows]
    if steps != sorted(steps) or steps[-1] <= 0:
        fail('the fused metrics rows\' steps are not monotonic: %s' % steps)


def phase_fused(torch, repo, make_env, learner_line, tmp):
    """Runs the fused loop into ``tmp`` (kept for phase 8)."""
    import math
    import numpy as np
    from handyrl_tpu_torch.evaluation import load_model
    from handyrl_tpu_torch.model import param_trees
    from handyrl_tpu_torch.utils import flax_msgpack
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    line, wall = run_fused_entry(repo, tmp)
    models = os.path.join(tmp, 'models')
    if line['epochs'] != FUSED_EPOCHS or line['failed']:
        fail('the fused learner trained %s epochs' % line['epochs'])
    retraces = (line.get('telemetry') or {}).get('retraces')
    log('fused learner: %s retraces after warm-up' % retraces)
    if retraces != 0:
        fail('the fused learner counted %s retraces after warm-up (a CUDA '
             'graph captured or a kernel built in steady state)' % retraces)
    secs = sorted(line['epoch_seconds'])
    log('fused: %s; epoch_seconds of %d epochs: min %.3f, median %.3f, '
        'max %.3f, sum %.2f' % (
            json.dumps({k: v for k, v in line.items()
                        if k not in ('epoch_seconds', 'epoch_steps')}),
            len(secs), secs[0], secs[len(secs) // 2], secs[-1],
            sum(secs)))
    loop = line['loop_seconds']
    log('fused: the loop\'s host seconds: dispatch %.3f, fetch %.3f, '
        'evaluation %.3f, epoch close %.3f, of which the wait for the '
        'in-flight dispatch before a checkpoint %.3f and the checkpoint\'s '
        'copies and files %.3f' % (
            loop['dispatch'], loop['fetch'], loop['evaluation'],
            loop['epoch_close'], loop['checkpoint_wait'],
            loop['checkpoint_write']))
    steps = line['steps_at_exit']
    if steps != line['fused_dispatches'] * FUSED_K or steps <= 0:
        fail('the fused learner took %d steps in %d fused dispatches of '
             '%d' % (steps, line['fused_dispatches'], FUSED_K))
    want = sorted(set(range(FUSED_INTERVAL, FUSED_EPOCHS + 1,
                            FUSED_INTERVAL)) | {FUSED_EPOCHS})
    got = sorted(int(n.split('.')[0]) for n in os.listdir(models)
                 if n.endswith('.ckpt') and n.split('.')[0].isdigit())
    if got != want:
        fail('the fused loop wrote checkpoints %s, not %s' % (got, want))
    names = ['%d.ckpt' % e for e in want] + [
        'latest.ckpt', 'trainer_state.ckpt']
    for name in names:
        ok, reason = verify_checkpoint(os.path.join(models, name))
        if not ok or reason != 'ok':
            fail('fused checkpoint %s: %s' % (name, reason))
    rows = read_metrics(os.path.join(tmp, 'metrics.jsonl'))
    check_metrics_rows(rows, FUSED_EPOCHS)
    log('fused: %d metrics rows; the last: %s' % (
        len(rows), json.dumps({k: v for k, v in rows[-1].items()
                               if k != 'telemetry'})))
    if not (line['losses'] and all(math.isfinite(v)
                                   for v in line['losses'].values())):
        fail('the fused learner reports non-finite losses: %s'
             % line['losses'])
    by_path = line['kernel_launches']
    for path, kernels in FUSED_PATHS.items():
        for k in kernels:
            if not by_path.get(path, {}).get(k, 0) > 0:
                fail('the fused loop\'s %s never launched %s' % (path, k))
    train = by_path['training']
    for k in FUSED_PATHS['training']:
        if train[k] != steps:
            fail('the fused loop\'s training launched %s %d times in %d '
                 'steps' % (k, train[k], steps))
    if any(by_path.get(p, {}).get(k, 0)
           for p in ('generation', 'evaluation')
           for k in ('geese_trunk_bwd', 'td_lambda', 'upgo', 'vtrace')):
        fail('the fused loop\'s generation or evaluation launched a '
             'training kernel')
    log('fused: %d steps in %d fused dispatches (+ %d warm-up), kernel '
        'launches by path %s' % (steps, line['fused_dispatches'],
                                 line['warm_dispatches'], by_path))

    env = make_env(FUSED_CONFIG['env_args'])
    _, from_flax = param_trees(env.net())

    def params(name):
        with open(os.path.join(models, name), 'rb') as f:
            return from_flax(flax_msgpack.from_bytes(f.read()))
    first = params('%d.ckpt' % FUSED_INTERVAL)
    last = params('%d.ckpt' % FUSED_EPOCHS)
    moved = {k: (last[k] - first[k]).abs().max().item() for k in first}
    log('fused: params max abs change from %d.ckpt to %d.ckpt by leaf: '
        '%s' % (FUSED_INTERVAL, FUSED_EPOCHS,
                ', '.join('%s %.3g' % kv for kv in moved.items())))
    still = [k for k, v in moved.items() if not v > 0]
    if still:
        fail('the fused loop did not move %s' % still)
    obs = np.stack(game_observations(make_env, 64, SEED + 6))
    card = load_model(os.path.join(models, 'latest.ckpt'), env, 'cuda')
    cpu = load_model(os.path.join(models, 'latest.ckpt'), env, 'cpu')
    got, want = card.batch_inference(obs), cpu.batch_inference(obs)
    err = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    log('fused: latest.ckpt forward on the card vs the CPU over %d real '
        'boards: max abs err %s (tol %.0e)' % (len(obs), err,
                                               POLICY_TOL))
    if not all(np.isfinite(got[k]).all() for k in got) or \
            max(err.values()) > POLICY_TOL:
        fail('the fused loop\'s checkpoint computes other outputs on the '
             'card than on the CPU')

    fused_env_checks(torch)
    fp, _, tg, args = fused_setup(torch)
    fused_ingest_and_step_checks(torch, fp, tg, args)
    profile = fused_profile(torch, fp, args)
    fp.release()
    del fp
    torch.cuda.empty_cache()
    log('fused vs the host learner (phase 5), same card (%s): %.1f vs %.1f '
        'episodes/s, %.2f vs %.2f SGD steps/s, %.1f vs %.1f trajectories/s '
        '(B=64 vs 128), peak memory %.1f vs %.1f MiB; fused: %d epochs in '
        '%.1f s of process wall, sample reuse %.2f, %d windows ingested '
        '(ring %d of %d), dispatch %.2f s and fetch %.2f s on the host; a '
        'steady dispatch %.3f ms, device busy %.3f ms, idle %.1f%%' % (
            nvidia_smi_line(), line['episodes_per_s'],
            learner_line['episodes_per_s'], line['sgd_steps_per_s'],
            learner_line['update_steps_per_s'], line['trajectories_per_s'],
            learner_line['trajectories_per_s'], line['peak_memory_mib'],
            learner_line['peak_memory_mib'], line['epochs'], wall,
            line['sample_reuse'], line['windows_ingested'],
            line['ring_size'], line['ring_capacity'],
            line['dispatch_seconds'], line['fetch_seconds'],
            profile['dispatch_ms_profiled'], profile['device_busy_ms'],
            100 * profile['idle_share']))
    return {'line': line, 'profile': profile, 'wall': wall}


# ---------------------------------------------------- phase 7: quick start

# the README's quick start: tictactoe.json (config.yaml's env_args and
# train_args: turn-based TicTacToe, the full-width SimpleConv2dModel, TD/TD,
# lambda 0.7, gamma 0.8, B=128, T=16, 64 envs, 400 episodes before the first
# epoch and 200 an epoch, evaluation against 'random'), cut to QUICK_EPOCHS
# epochs (config.yaml runs forever); then the offline tournament of its
# latest.ckpt against 'random'. The learning bar is tests/test_train_e2e.py's
# slow test: over the last QUICK_LAST epochs at least QUICK_MIN_RESULTS
# evaluation results and a win rate above QUICK_MIN_WIN_RATE.
QUICK_CONFIG = 'tictactoe.json'
QUICK_EPOCHS = 6        # 15 until phase 18, 10 until phase 19, 8 until
                        # telemetry (PERF.md §4)
QUICK_LAST = 5
QUICK_MIN_RESULTS, QUICK_MIN_WIN_RATE = 80, 0.6
QUICK_GAMES, QUICK_PROCS = 100, 4
QUICK_TARGETS = (16, 2, 256)   # (T, P, lanes) of the turn-based step's K3
QUICK_FILES = ['%d.ckpt' % e for e in range(1, QUICK_EPOCHS + 1)] + [
    'latest.ckpt', 'trainer_state.ckpt']
# 7(b): the same with batcher processes and shared-memory batches, cut to
# QUICK_SHM_EPOCHS epochs
QUICK_SHM_EPOCHS = 5     # 8 until phase 17 needed the time (PERF.md §4)
# 7(c): the same on the fused device loop, config.yaml's commented lines
QUICK_FUSED_EPOCHS = 15
QUICK_FUSED_K = 16
QUICK_FUSED_INTERVAL = 10
QUICK_FUSED = {'device_generation': True, 'device_replay': True,
               'sgd_steps_per_chunk': QUICK_FUSED_K,
               'checkpoint_interval': QUICK_FUSED_INTERVAL}


def tictactoe_observations(make_env, count, seed):
    """``count`` real TicTacToe observations, from both seats' views."""
    import random
    rng = random.Random(seed)
    env = make_env({'env': 'TicTacToe'})
    obs = []
    while len(obs) < count:
        if env.terminal():
            env.reset()
        obs += [env.observation(p) for p in env.players()]
        env.play(rng.choice(env.legal_actions()))
    return obs[:count]


def quick_config(repo, extra=None, epochs=QUICK_EPOCHS):
    """tictactoe.json with ``extra`` train_args and ``epochs``."""
    with open(os.path.join(repo, QUICK_CONFIG)) as f:
        cfg = json.load(f)
    cfg['train_args'].update(extra or {})
    cfg['train_args']['epochs'] = epochs
    return cfg


def run_quick_start(repo, tmp, extra=None, epochs=QUICK_EPOCHS):
    """``python -m handyrl_tpu_torch.train --config`` on tictactoe.json with
    ``extra`` train_args, ``epochs`` epochs and a temporary model_dir (no
    --device: the card is the default). Returns its JSON line (with its
    wall time as 'wall'), its epoch lines and its whole output."""
    cfg = quick_config(repo, extra, epochs)
    cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
    path = os.path.join(tmp, 'quick_start.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             path], cwd=repo, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as exc:
        fail('the quick start did not finish within 600 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        fail('the quick start exited %d:\n%s' % (proc.returncode,
                                                 proc.stderr[-4000:]))
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    if len(lines) != 1:
        fail('the quick start printed %d JSON lines' % len(lines))
    shown = [l for l in proc.stdout.splitlines()
             if l.startswith(('epoch', 'win rate', 'loss', 'batcher proc',
                              'fused device'))]
    line = json.loads(lines[0])
    line['wall'] = wall
    return line, shown, proc.stdout


def run_quick_eval(repo, ckpt):
    """``python -m handyrl_tpu_torch.evaluation CKPT QUICK_GAMES
    QUICK_PROCS --config tictactoe.json`` on the card: the tallies of its
    report by agent and its wall time."""
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.evaluation', ckpt,
             str(QUICK_GAMES), str(QUICK_PROCS), '--config', QUICK_CONFIG],
            cwd=repo, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as exc:
        fail('the tournament did not finish within 300 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        fail('the tournament exited %d:\n%s' % (proc.returncode,
                                                proc.stderr[-4000:]))
    agents, report = parse_report(proc.stdout, QUICK_GAMES, QUICK_PROCS,
                                  'the tournament')
    return agents, report, wall


def parse_report(stdout, games, procs, label):
    """A tournament's report in the JAX package's format: its header lines
    (``N process, G games``, ``total games = G``), then by agent the
    ``---agent N---`` line and ``LABEL {score: count} WIN_RATE`` lines.
    Returns ({agent: {label: (tally, win rate)}}, the report's lines)."""
    import ast
    out = stdout.splitlines()
    head = '%d process, %d games' % (procs, games)
    if head not in out or 'total games = %d' % games not in out:
        fail('%s did not print its header lines' % label)
    agents, report = {}, []
    for line in out:
        if line.startswith('---agent '):
            current = int(line.strip('-').split()[1])
            report.append(line)
        elif line.startswith(('default', 'total ')) and report:
            name, rest = line.split(' ', 1)
            tally_text, wp = rest.rsplit(' ', 1)
            agents.setdefault(current, {})[name] = (
                ast.literal_eval(tally_text), float(wp))
            report.append(line)
    return agents, report


def check_quick_run(torch, line, models, epochs, label, files,
                    warmup_steps):
    """A quick-start run's checks: ``epochs`` closed with finite losses,
    ``files`` pass ``verify_checkpoint``, the params moved from the first
    numbered checkpoint to the last, K3 launched once a step (plus
    ``warmup_steps`` eager steps of a capture) under 'training' and no
    other kernel anywhere."""
    import math
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.model import param_trees
    from handyrl_tpu_torch.utils import flax_msgpack
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    log('%s: %s' % (label, json.dumps(line)))
    if line['epochs'] != epochs or line['failed']:
        fail('the %s trained %s epochs (failed %s)'
             % (label, line['epochs'], line['failed_reason']))
    for name in files:
        ok, reason = verify_checkpoint(os.path.join(models, name))
        if not ok or reason != 'ok':
            fail('%s checkpoint %s: %s' % (label, name, reason))
    if not (line['losses'] and all(math.isfinite(v)
                                   for v in line['losses'].values())):
        fail('the %s reports non-finite losses: %s' % (label,
                                                       line['losses']))
    _, from_flax = param_trees(make_env({'env': 'TicTacToe'}).net())

    def params(name):
        with open(os.path.join(models, name), 'rb') as f:
            return from_flax(flax_msgpack.from_bytes(f.read()))
    numbered = [n for n in files if n.split('.')[0].isdigit()]
    first, last = params(numbered[0]), params(numbered[-1])
    moved = {k: (last[k] - first[k]).abs().max().item() for k in first}
    if not any(v > 0 for v in moved.values()):
        fail('the %s\'s params did not change from %s to %s'
             % (label, numbered[0], numbered[-1]))

    # K3 once an update step (and each capture warm-up), nothing else:
    # the net's convs are PyTorch's, as the JAX package leaves them to XLA
    by_path = line['kernel_launches']
    runs = line['steps_at_exit'] + warmup_steps
    train = by_path.get('training', {})
    log('%s: kernel launches by path %s; %d update steps (and %d eager '
        'warm-up steps of a capture)' % (label, by_path,
                                          line['steps_at_exit'],
                                          warmup_steps))
    if train.get('td_lambda') != runs:
        fail('the %s launched K3 %s times in %d steps'
             % (label, train.get('td_lambda'), runs))
    others = {(p, k): v for p, c in by_path.items() for k, v in c.items()
              if v and (p, k) != ('training', 'td_lambda')}
    if others:
        fail('the %s launched other kernels: %s' % (label, others))


def check_quick_forward(torch, make_env, models, label):
    """``latest.ckpt``'s forward on the card against the CPU's on 256 real
    boards (POLICY_TOL)."""
    import numpy as np
    from handyrl_tpu_torch.evaluation import load_model
    env = make_env({'env': 'TicTacToe'})
    obs = np.stack(tictactoe_observations(make_env, 256, SEED + 6))
    ckpt = os.path.join(models, 'latest.ckpt')
    card = load_model(ckpt, env, 'cuda')
    cpu = load_model(ckpt, env, 'cpu')
    got, want = card.batch_inference(obs), cpu.batch_inference(obs)
    err = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    log('%s: latest.ckpt forward on the card vs the CPU over %d real '
        'boards: max abs err %s (tol %.0e)' % (label, len(obs), err,
                                               POLICY_TOL))
    if not all(np.isfinite(got[k]).all() for k in got) or \
            max(err.values()) > POLICY_TOL:
        fail('the %s\'s checkpoint computes other outputs on the card than '
             'on the CPU' % label)


def check_learning_bar(line, label):
    """tests/test_train_e2e.py's slow bar over the last QUICK_LAST epochs:
    >= QUICK_MIN_RESULTS evaluation results, a win rate above
    QUICK_MIN_WIN_RATE. Returns (results, win rate)."""
    last_epoch = line['model_epoch'] - 1
    n = r = 0
    for epoch in range(max(1, last_epoch - QUICK_LAST + 1), last_epoch + 1):
        en, er = line['eval_by_epoch'].get(str(epoch), (0, 0))
        n, r = n + en, r + er
    win_rate = (r / (n + 1e-6) + 1) / 2
    log('%s: %d evaluation results over epochs %d-%d, win rate %.4f '
        'against random (bar: >= %d results, > %.2f)' % (
            label, n, max(1, last_epoch - QUICK_LAST + 1), last_epoch,
            win_rate, QUICK_MIN_RESULTS, QUICK_MIN_WIN_RATE))
    if n < QUICK_MIN_RESULTS or not win_rate > QUICK_MIN_WIN_RATE:
        fail('the %s missed the learning bar: %d results, win rate %.4f'
             % (label, n, win_rate))
    return n, win_rate


def phase_quick_start(torch, repo, make_env, k3_rows, keep=None):
    """Phase 7; its numbered checkpoints are copied into ``keep`` (the
    SWA tool's input in phase 19)."""
    from handyrl_tpu_torch.ops.train_step import GRAPH_WARMUP_STEPS
    tmp = tempfile.mkdtemp(prefix='chip_smoke_quick_')
    try:
        line, shown, _ = run_quick_start(repo, tmp)
        wall = line['wall']
        for l in shown:
            log('  quick start: %s' % l)
        models = os.path.join(tmp, 'models')
        check_quick_run(torch, line, models, QUICK_EPOCHS, 'quick start',
                        QUICK_FILES, GRAPH_WARMUP_STEPS)
        if keep:
            for epoch in range(1, QUICK_EPOCHS + 1):
                shutil.copy(os.path.join(models, '%d.ckpt' % epoch), keep)
        check_quick_forward(torch, make_env, models, 'quick start')
        n, win_rate = check_learning_bar(line, 'quick start')
        steps = [b - a for a, b in zip([0] + line['epoch_steps'],
                                       line['epoch_steps'])]
        ckpt = os.path.join(models, 'latest.ckpt')
        agents, report, eval_wall = run_quick_eval(repo, ckpt)
        for l in report:
            log('  tournament: %s' % l)
        totals = {a: sum(t['total'][0].values()) for a, t in agents.items()}
        if sorted(agents) != [0, 1] or set(totals.values()) != {QUICK_GAMES}:
            fail('the tournament counted %s games by agent' % totals)
        eval_wp = agents[0]['total'][1]
        k3 = k3_rows[('td_lambda',) + QUICK_TARGETS]
        log('quick start: %.1f episodes/s, %.2f SGD steps/s, %.1f '
            'trajectories/s, steps per epoch %s, %d episodes, %d evaluation '
            'results, peak memory %.1f MiB, %.1f s process wall; K3 %.2f us at '
            '%d lanes (T=%d, P=%d; graph replay); tournament %d games in %d '
            'processes %.1f s, main agent win rate %.4f (%s)' % (
                line['episodes_per_s'], line['update_steps_per_s'],
                line['trajectories_per_s'], steps, line['episodes'],
                line['eval_results'], line['peak_memory_mib'], wall,
                1e3 * k3['ms'], QUICK_TARGETS[2], QUICK_TARGETS[0],
                QUICK_TARGETS[1], QUICK_GAMES, QUICK_PROCS, eval_wall,
                eval_wp, nvidia_smi_line()))
        return {'line': line, 'wall': wall, 'win_rate': win_rate,
                'eval_results': n, 'steps_per_epoch': steps,
                'eval_wall': eval_wall, 'eval_win_rate': eval_wp}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_quick_shm(torch, repo, quick):
    """Phase 7(b): the quick start with BATCHER_SWITCHES for
    QUICK_SHM_EPOCHS epochs: phase 7's run checks, the shared-memory path,
    /dev/shm, and its rates beside phase 7's threaded run."""
    from handyrl_tpu_torch.ops.train_step import GRAPH_WARMUP_STEPS
    tmp = tempfile.mkdtemp(prefix='chip_smoke_quick_shm_')
    try:
        before = shm_listing()
        line, shown, _ = run_quick_start(repo, tmp, BATCHER_SWITCHES,
                                         QUICK_SHM_EPOCHS)
        after = shm_listing()
        for l in shown:
            log('  quick start (shm): %s' % l)
        files = ['%d.ckpt' % e for e in range(1, QUICK_SHM_EPOCHS + 1)] + [
            'latest.ckpt', 'trainer_state.ckpt']
        check_quick_run(torch, line, os.path.join(tmp, 'models'),
                        QUICK_SHM_EPOCHS, 'quick start (shm)', files,
                        GRAPH_WARMUP_STEPS)
        check_shm_run('quick start (shm)', line, before, after)
        side_by_side('quick start, batcher threads (%d epochs) vs processes '
                     'with shared-memory batches (%d epochs)'
                     % (QUICK_EPOCHS, QUICK_SHM_EPOCHS),
                     ('threads', 'shm processes'), (quick['line'], line))
        return {'line': line}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def quick_twin_checks(torch):
    """The TicTacToe twin's step, auto_reset, observe, legal_mask, turn,
    terminal and outcome on the card against the CPU, on 256 games after
    5 random plies (finished ones reset) and the same actions: equal
    exactly, every field."""
    from handyrl_tpu_torch.envs import torch_tictactoe as tt
    gen = torch.Generator().manual_seed(SEED + 21)

    def random_legal(st):
        u = torch.rand((st.boards.shape[0], tt.N_ACTIONS), generator=gen)
        return torch.argmax(u * tt.legal_mask(st), dim=1)
    state = tt.init_state(256)
    for _ in range(5):
        state = tt.step(state, random_legal(state))
        state = tt.auto_reset(state, tt.terminal(state))
    acts = random_legal(state)

    def run(dev):
        st = tt.State(*[t.to(dev) for t in state])
        nxt = tt.step(st, acts.to(dev))
        done = tt.terminal(nxt)
        out = {'step.' + k: v for k, v in nxt._asdict().items()}
        out.update({'reset.' + k: v for k, v in
                    tt.auto_reset(nxt, done)._asdict().items()})
        out.update(observe=tt.observe(st), legal_mask=tt.legal_mask(st),
                   turn=tt.turn(st), terminal=done, outcome=tt.outcome(nxt))
        return {k: v.cpu() for k, v in out.items()}

    card, cpu = run('cuda'), run('cpu')
    bad = [k for k in cpu if not torch.equal(card[k], cpu[k])]
    log('quick fused: the TicTacToe twin on the card vs the CPU, 256 games: '
        '%d fields (%d finished games), unequal %s'
        % (len(cpu), int(cpu['terminal'].sum()), bad))
    if bad:
        fail('the TicTacToe twin computes other values on the card than on '
             'the CPU in %s' % bad)


def quick_fused_setup(torch, repo):
    """An in-process fused pipeline at the quick start's widths on the card
    ('turn' layout): (pipeline, env module, args, loss config, net
    factory)."""
    from handyrl_tpu_torch.config import apply_defaults
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.envs import torch_tictactoe as tt
    from handyrl_tpu_torch.ops.device_windows import DeviceWindower
    from handyrl_tpu_torch.ops.fused_pipeline import FusedPipeline
    from handyrl_tpu_torch.ops.replay import (
        resolve_windows_per_episode, ring_capacity, windows_per_episode)
    from handyrl_tpu_torch.ops.train_step import ReplayUpdateStep, \
        init_train_state
    from handyrl_tpu_torch.train import loss_config
    args = apply_defaults(quick_config(repo, QUICK_FUSED,
                                       QUICK_FUSED_EPOCHS))['train_args']
    resolve_windows_per_episode(args, tt)    # as the learner sizes it
    env = make_env({'env': 'TicTacToe'})

    def make_net(seed):
        net = env.net()
        if seed is not None:
            net.reset_parameters(torch.Generator().manual_seed(seed))
        return net
    net = make_net(SEED).cuda()
    actor = make_net(None).cuda()
    actor.load_state_dict(net.state_dict())
    cfg = loss_config(args)._replace(observation=False)
    step = ReplayUpdateStep(net, cfg, init_train_state(net))
    windower = DeviceWindower(
        'turn', args['forward_steps'], 0, tt.MAX_STEPS,
        windows_per_episode(args), ring_capacity(args), tt.NUM_PLAYERS,
        args['gamma'], False)
    fp = FusedPipeline(tt, actor, step, windower, args['generation_envs'],
                       args['device_chunk_steps'], QUICK_FUSED_K,
                       args['batch_size'], seed=SEED)
    return fp, tt, args, cfg, make_net


def phase_quick_fused(torch, repo, make_env, quick):
    """Phase 7(c): the quick start on the fused loop ('turn' layout)."""
    import math
    tmp = tempfile.mkdtemp(prefix='chip_smoke_quick_fused_')
    try:
        line, shown, stdout = run_quick_start(repo, tmp, QUICK_FUSED,
                                              QUICK_FUSED_EPOCHS)
        for l in shown[:8] + shown[-6:]:
            log('  quick fused: %s' % l)
        if 'fused device pipeline' not in stdout or \
                '(turn mode)' not in stdout:
            fail('the quick start did not run the fused pipeline in turn '
                 'mode:\n%s' % stdout[-2000:])
        # an epoch's loss line sums the metrics read by its close; they
        # arrive a dispatch late, so the first epoch's may be empty
        losses = [[float(kv.split(':')[1])
                   for kv in l[len('loss = '):].split()]
                  for l in stdout.splitlines() if l.startswith('loss = ')]
        if len(losses) != QUICK_FUSED_EPOCHS or not all(
                vals and all(math.isfinite(v) for v in vals)
                for vals in losses[1:]):
            fail('the fused quick start closed %d of %d epochs, with losses '
                 '%s' % (len(losses), QUICK_FUSED_EPOCHS, losses))
        steps = line['steps_at_exit']
        if steps != line['fused_dispatches'] * QUICK_FUSED_K or steps <= 0:
            fail('the fused quick start took %d steps in %d fused '
                 'dispatches of %d' % (steps, line['fused_dispatches'],
                                       QUICK_FUSED_K))
        models = os.path.join(tmp, 'models')
        epochs = sorted(set(range(QUICK_FUSED_INTERVAL,
                                  QUICK_FUSED_EPOCHS + 1,
                                  QUICK_FUSED_INTERVAL))
                        | {QUICK_FUSED_EPOCHS})
        got = sorted(int(n.split('.')[0]) for n in os.listdir(models)
                     if n.endswith('.ckpt') and n.split('.')[0].isdigit())
        if got != epochs:
            fail('the fused quick start wrote checkpoints %s, not %s'
                 % (got, epochs))
        files = ['%d.ckpt' % e for e in epochs] + ['latest.ckpt',
                                                   'trainer_state.ckpt']
        # a graph's first call runs eagerly as a real step: no warm-ups
        check_quick_run(torch, line, models, QUICK_FUSED_EPOCHS,
                        'quick fused', files, 0)
        check_quick_forward(torch, make_env, models, 'quick fused')
        n, win_rate = check_learning_bar(line, 'quick fused')

        quick_twin_checks(torch)
        fp, tt, args, cfg, make_net = quick_fused_setup(torch, repo)
        fused_ingest_and_step_checks(torch, fp, tt, args, mode='turn',
                                     make_net=make_net, cfg=cfg)
        for _ in range(2):   # the chunk graph: eager, then captured
            fp.warm_step()
        parts = dispatch_parts_ms(torch, fp, args, QUICK_FUSED_K,
                                  'quick fused')
        fp.release()
        del fp
        torch.cuda.empty_cache()
        host = quick['line']
        log('quick start, fused loop vs the host learner (phase 7), same '
            'card (%s): %.1f vs %.1f episodes/s, %.2f vs %.2f SGD steps/s, '
            '%.1f vs %.1f trajectories/s (B=128), %.1f vs %.1f s of process '
            'wall for %d vs %d epochs; fused: %d steps in %d dispatches (+ '
            '%d warm-up), sample reuse %.2f, %d windows ingested (ring %d of '
            '%d), a steady dispatch: chunk %.3f ms, %d steps %.3f ms; %d '
            'evaluation results over the last %d epochs, win rate %.4f' % (
                nvidia_smi_line(), line['episodes_per_s'],
                host['episodes_per_s'], line['sgd_steps_per_s'],
                host['update_steps_per_s'], line['trajectories_per_s'],
                host['trajectories_per_s'], line['wall'], host['wall'],
                QUICK_FUSED_EPOCHS, QUICK_EPOCHS, steps,
                line['fused_dispatches'], line['warm_dispatches'],
                line['sample_reuse'], line['windows_ingested'],
                line['ring_size'], line['ring_capacity'], parts['chunk'],
                QUICK_FUSED_K, parts['steps'], n, QUICK_LAST, win_rate))
        return {'line': line, 'parts': parts, 'win_rate': win_rate}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------- phase 8: scoring and preemption

# (a) phase 6's checkpoints at epoch FUSED_INTERVAL and at its last, scored
# offline by scripts/torch_eval_checkpoints.py (one evaluator, one captured
# rollout, SCORE_GAMES games a point against 'random', a fresh process);
# the bar is under the JAX package's curves (0.985-0.991 at epoch 160,
# north_star_device_curve{,_r5}.jsonl)
SCORE_GAMES = 512
SCORE_ENVS = 64
SCORE_MIN_LAST = 0.95
# (b) the preemption drill: phase 6's model dir resumed (restart_epoch -1)
# for DRILL_EPOCHS more epochs with keep_checkpoints DRILL_KEEP, SIGTERMed
# once its first metrics row lands, then restarted to its end
DRILL_EPOCHS = 6
DRILL_KEEP = 3


def run_scorer(repo, models, out):
    """The scorer on epochs FUSED_INTERVAL and FUSED_EPOCHS of ``models``:
    its rows and its summary line."""
    every = FUSED_EPOCHS // FUSED_INTERVAL - 1   # picks the first and last
    cmd = [sys.executable, 'scripts/torch_eval_checkpoints.py', models,
           'HungryGeese', out, '--every', str(every), '--games',
           str(SCORE_GAMES), '--envs', str(SCORE_ENVS), '--opponent',
           'random', '--env-args', json.dumps(FUSED_CONFIG['env_args'])]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                              timeout=300)
    except subprocess.TimeoutExpired as exc:
        fail('the scorer did not finish within 300 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        fail('the scorer exited %d:\n%s' % (proc.returncode,
                                            proc.stderr[-4000:]))
    lines = [json.loads(l) for l in proc.stdout.splitlines()
             if l.startswith('{')]
    return read_metrics(out), lines[-1], wall


def drill_config(tmp, epochs):
    cfg = json.loads(json.dumps(FUSED_CONFIG))
    cfg['train_args'].update(
        model_dir=os.path.join(tmp, 'models'), restart_epoch=-1,
        epochs=epochs, keep_checkpoints=DRILL_KEEP,
        metrics_jsonl=os.path.join(tmp, 'metrics.jsonl'))
    path = os.path.join(tmp, 'drill.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    return path


def run_drill(repo, tmp, epochs):
    """The resumed learner, SIGTERMed once a new metrics row lands; then
    its restart. Returns both runs' (returncode, stdout) and the walls."""
    path = drill_config(tmp, epochs)
    metrics = os.path.join(tmp, 'metrics.jsonl')
    rows_before = len(read_metrics(metrics))
    cmd = [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config', path]
    out_path = os.path.join(tmp, 'drill_first.log')
    t0 = time.monotonic()
    with open(out_path, 'w') as out:
        proc = subprocess.Popen(cmd, cwd=repo, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 300
            while (len(read_metrics(metrics)) <= rows_before
                   and proc.poll() is None and time.monotonic() < deadline):
                time.sleep(0.05)
            if proc.poll() is not None:
                fail('the resumed learner exited %s before its first row'
                     % proc.returncode)
            if time.monotonic() >= deadline:
                fail('the resumed learner wrote no row within 300 s')
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(out_path) as f:
        first = (rc, f.read(), time.monotonic() - t0)
    t0 = time.monotonic()
    try:
        again = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                               timeout=600)
    except subprocess.TimeoutExpired as exc:
        fail('the restarted learner did not finish within 600 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    second = (again.returncode, again.stdout + again.stderr,
              time.monotonic() - t0)
    return first, second


def phase_score_and_drill(repo, tmp):
    import re
    from handyrl_tpu_torch import guard
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    models = os.path.join(tmp, 'models')

    rows, summary, wall = run_scorer(repo, models,
                                     os.path.join(tmp, 'curve.jsonl'))
    epochs = [r['epoch'] for r in rows]
    if epochs != [FUSED_INTERVAL, FUSED_EPOCHS]:
        fail('the scorer scored epochs %s' % epochs)
    if any(r['games'] < SCORE_GAMES or r['opponent'] != 'random'
           or set(r) != {'epoch', 'opponent', 'games', 'win_rate', 'mean'}
           for r in rows):
        fail('the scorer\'s rows: %s' % rows)
    first, last = rows
    if not (last['win_rate'] >= SCORE_MIN_LAST
            and last['win_rate'] >= first['win_rate']):
        fail('scored win rates against random: epoch %d %.4f, epoch %d '
             '%.4f (bar: the last >= %.2f and not below the first)' % (
                 first['epoch'], first['win_rate'], last['epoch'],
                 last['win_rate'], SCORE_MIN_LAST))
    by_path = summary['kernel_launches']
    launched = {(p, k) for p, counts in by_path.items()
                for k, n in counts.items() if n}
    if launched != {('evaluation', 'geese_trunk')} or \
            summary['rollout_graphs'] != 1:
        fail('the scorer launched %s with %s rollout graphs'
             % (by_path, summary['rollout_graphs']))
    log('score: %s; %d dispatches, K1 launches %s, one rollout graph, '
        '%.2f s scoring, %.1f s process wall (%s)' % (
            ', '.join('epoch %d %.4f (%d games, mean %.4f)' % (
                r['epoch'], r['win_rate'], r['games'], r['mean'])
                for r in rows),
            summary['dispatches'], by_path, summary['seconds'], wall,
            nvidia_smi_line()))

    end = FUSED_EPOCHS + DRILL_EPOCHS
    (rc1, out1, wall1), (rc2, out2, wall2) = run_drill(repo, tmp, end)
    if rc1 != guard.PREEMPT_EXIT_CODE or \
            'preempted: checkpoint flushed' not in out1:
        fail('the SIGTERMed learner exited %s:\n%s' % (rc1, out1[-3000:]))
    m = re.search(r'preempted: checkpoint flushed at epoch (\d+) \(steps '
                  r'(\d+)\)', out1)
    flushed, flushed_steps = int(m.group(1)), int(m.group(2))
    ok, reason = verify_checkpoint(os.path.join(models, 'trainer_state.ckpt'))
    if not ok:
        fail('the flushed trainer_state.ckpt: %s' % reason)
    if rc2 != 0 or ('auto-resume: newest valid checkpoint is epoch %d'
                    % flushed) not in out2:
        fail('the restarted learner exited %s:\n%s' % (rc2, out2[-3000:]))
    scored = rows
    rows = read_metrics(os.path.join(tmp, 'metrics.jsonl'))
    pre = [r for r in rows if r.get('preempted')]
    if len(pre) != 1 or pre[0]['steps'] != flushed_steps:
        fail('preempted rows: %s' % pre)
    steps = [r['steps'] for r in rows]
    epochs = [r['epoch'] for r in rows if not r.get('preempted')]
    if steps != sorted(steps) or len(epochs) != len(set(epochs)) or \
            max(epochs) != end:
        fail('the metrics rows across the restart: epochs %s, steps %s'
             % (epochs[-12:], steps[-12:]))
    kept = sorted(int(n.split('.')[0]) for n in os.listdir(models)
                  if n.endswith('.ckpt') and n.split('.')[0].isdigit())
    if len(kept) != DRILL_KEEP or kept[-1] != end or flushed not in kept:
        fail('numbered checkpoints after the drill: %s' % kept)
    line = json.loads([l for l in out2.splitlines() if l.startswith('{')][-1])
    if not line['warm_dispatches'] >= 1:
        fail('the restart trained before refilling its ring: %s' % line)
    log('drill: SIGTERM after the first resumed row, exit %d in %.1f s, '
        'flushed epoch %d (steps %d); restart exit 0 in %.1f s to epoch %d '
        '(%d warm-up dispatches before training again); numbered checkpoints '
        'kept %s (keep_checkpoints %d); %d metrics rows, steps monotonic' % (
            rc1, wall1, flushed, flushed_steps, wall2, end,
            line['warm_dispatches'], kept, DRILL_KEEP, len(rows)))
    return {'score': scored, 'score_summary': summary}


# ------------------------------------------------ phase 9: the worker plane

# (a) the local cluster: phase 5's config with batched_generation false
WORKERS_LOCAL = {'batched_generation': False, 'worker': {'num_parallel': 6},
                 'epochs': 2, 'minimum_episodes': 128,
                 'update_episodes': 128}
# (b) the server and one worker host over localhost TCP, one gather killed
# (chaos) once the workers play: the host's supervisor respawns it, the
# learner re-issues what it stranded. A short quarantine, so that the
# host's walk back to healthy fits the phase.
# Model id 0 (epoch 0) is served as the RandomModel, as in the JAX
# package: a run's first epoch plays no forward (a few seconds). The kill
# comes 12.0 s after the host joined (the drill's first draw with seed 0
# is 1.8606 x its mean): its workers ask for tasks 5-9 s after it joins
# on an H100 host (a kill at 8.0 s once found no task booked), and the
# run's epochs of net-played episodes last well past it. A kill after the
# learner ended would leave the supervisor respawning against a closed
# port.
WORKERS_REMOTE = {'epochs': 3, 'minimum_episodes': 128,   # 4 until phase 17
                  'update_episodes': 128,
                  'fault_tolerance': {'host_quarantine_period': 5.0}}
REMOTE_WORKERS = 4
REMOTE_CHAOS = 'kill_gather=6.45,max_kills=1,seed=0'
PHASE9_TIMEOUT = 150
# 9(b)'s telemetry: every episode traced, the alert engine evaluated every
# second, metrics rows; the exporter's port, the trace and blackbox dirs
# and the rows' file are set per run
REMOTE_TELEMETRY = {'trace_sample_rate': 1.0, 'alerts': {'interval': 1.0}}
# beacons (and the registry snapshots they carry) every 2 s, not every 10
REMOTE_HEARTBEAT = 2.0
TRACE_CHAIN = ('task_assign', 'generate', 'upload', 'ingest', 'train_step')
# the environment the telemetry config is mirrored into: the processes
# take their settings from their config, never from this process's
TELEMETRY_ENV = ('HANDYRL_TPU_TRACE', 'HANDYRL_TPU_TRACE_RATE',
                 'HANDYRL_TPU_BLACKBOX', 'HANDYRL_TPU_RECORDER_EVENTS',
                 'HANDYRL_TPU_RUN_ID', 'HANDYRL_TPU_TELEMETRY',
                 'HANDYRL_TPU_RETRACE')
WORKER_PID = r'(?:started gather|opened worker) \d+ \(pid (\d+)\)'


_GIVEN_PORTS = set()       # free_ports' answers: parts run at once


def free_ports(n):
    """``n`` ports that were free a moment ago (bound to 0, released) and
    not given out before in this run."""
    import socket
    ports = []
    while len(ports) < n:
        socks = [socket.socket() for _ in range(n)]
        for s in socks:
            s.bind(('', 0))
        for s in socks:
            port = s.getsockname()[1]
            if port not in _GIVEN_PORTS and len(ports) < n:
                _GIVEN_PORTS.add(port)
                ports.append(port)
        for s in socks:
            s.close()
    return ports


def worker_plane_config(tmp, extra, worker_args=None):
    cfg = json.loads(json.dumps(LEARNER_CONFIG))
    cfg['train_args'].update(json.loads(json.dumps(extra)))
    cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
    if worker_args:
        cfg['worker_args'] = worker_args
    path = os.path.join(tmp, 'config.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    return path


def learner_json(label, out):
    lines = [l for l in out.splitlines() if l.startswith('{')]
    if len(lines) != 1:
        fail('%s printed %d JSON lines' % (label, len(lines)))
    return json.loads(lines[0])


def processes_left(text):
    """The gather and worker processes named in a run's log that still
    exist (a second after the run)."""
    import re
    time.sleep(1.0)
    return [int(p) for p in re.findall(WORKER_PID, text)
            if os.path.exists('/proc/%s' % p)]


def check_worker_plane_line(label, line, epochs, workers_k1=True):
    """The learner's JSON line of a worker-plane run: epochs with finite
    losses, K1, K2 and K3 once a training step (and the capture's warm-up
    steps) and nothing else in this process, K1 and nothing else in the
    worker processes (``workers_k1`` None: K1 may be 0 too, as for engine
    workers that failed over; False: nothing at all, engine mode), an
    empty ledger, every episode counted once."""
    import math
    from handyrl_tpu_torch.ops.train_step import GRAPH_WARMUP_STEPS
    if line['epochs'] != epochs or line['failed'] or line['fleet_failure']:
        fail('%s trained %s epochs (failed %s %s %s)' % (
            label, line['epochs'], line['failed'], line['failed_reason'],
            line['fleet_failure']))
    if not (line['losses'] and all(math.isfinite(v)
                                   for v in line['losses'].values())):
        fail('%s reports non-finite losses: %s' % (label, line['losses']))
    by_path = line['kernel_launches']
    runs = line['steps_at_exit'] + GRAPH_WARMUP_STEPS
    train = by_path.get('training', {})
    if set(by_path) - {'training'}:
        fail('%s launched kernels outside training in the learner: %s'
             % (label, by_path))
    for name in ('geese_trunk', 'geese_trunk_bwd', 'td_lambda'):
        if train.get(name) != runs:
            fail('%s training launched %s %s times in %d steps'
                 % (label, name, train.get(name), runs))
    workers = line['worker_kernel_launches']
    if workers_k1 is not False and (
            (workers_k1 and not workers.get('geese_trunk', 0) > 0)
            or any(n for k, n in workers.items() if k != 'geese_trunk')):
        fail('%s worker processes launched %s (K1 and nothing else '
             'expected)' % (label, workers))
    if workers_k1 is False and any(workers.values()):
        fail('%s worker processes launched %s (nothing expected: their '
             'gather\'s engine runs the forwards)' % (label, workers))
    fleet = line['fleet']
    if fleet['outstanding'] != 0 or fleet['live'] != 0:
        fail('%s ended with tasks outstanding or peers attached: %s'
             % (label, fleet))
    if line['repeated_sample_keys'] or \
            line['distinct_sample_keys'] != line['episodes']:
        fail('%s counted an episode twice: %d repeated sample keys, %d '
             'distinct for %d episodes' % (
                 label, line['repeated_sample_keys'],
                 line['distinct_sample_keys'], line['episodes']))
    if not all(s['device'].startswith('cuda')
               for s in line['worker_stats'].values()):
        fail('%s workers ran off the card: %s' % (label,
                                                   line['worker_stats']))


def worker_ply_line(line):
    """One worker's seconds a generated ply, and the range over all."""
    stats = sorted(line['worker_stats'].items())
    plies = [(k, s['ply_seconds'], s['plies']) for k, s in stats
             if s.get('ply_seconds')]
    if not plies:
        fail('no worker reported a ply played by the net: %s' % stats)
    k, ply_s, n = plies[0]
    rand = [(s['random_seconds'], s['random_plies']) for _, s in stats]
    return ('worker %s: %.2f ms a ply played by the net (%d plies); all %d '
            'workers %.2f-%.2f ms; by model id 0 (no forward) %.2f ms a ply '
            '(%d plies over all); fetching and materializing models %.2f s '
            'a worker' % (
                k, ply_s * 1e3, n, len(plies),
                min(p[1] for p in plies) * 1e3,
                max(p[1] for p in plies) * 1e3,
                1e3 * sum(r[0] for r in rand) / max(1, sum(r[1] for r in rand)),
                sum(r[1] for r in rand),
                sum(s['model_seconds'] for _, s in stats) / len(stats)))


def phase_workers_local(torch, repo, make_env, learner):
    """Phase 9(a): the local cluster through the entry point, no
    --device."""
    from handyrl_tpu_torch.model import param_trees
    from handyrl_tpu_torch.utils import flax_msgpack
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    tmp = tempfile.mkdtemp(prefix='chip_smoke_workers_')
    try:
        path = worker_plane_config(tmp, WORKERS_LOCAL)
        t0 = time.monotonic()
        try:
            proc = subprocess.run(
                [sys.executable, '-m', 'handyrl_tpu_torch.train',
                 '--config', path], cwd=repo, capture_output=True,
                text=True, timeout=PHASE9_TIMEOUT)
        except subprocess.TimeoutExpired as exc:
            fail('the local cluster did not finish within %d s:\n%s' % (
                PHASE9_TIMEOUT, (exc.stderr or b'')[-4000:]))
        wall = time.monotonic() - t0
        for l in proc.stdout.splitlines():
            if l.startswith(('epoch', 'win rate', 'generation stats', 'loss',
                             'updated model', 'fleet:')):
                log('  workers: %s' % l)
        if proc.returncode != 0:
            fail('the local cluster exited %d:\n%s' % (
                proc.returncode, proc.stderr[-4000:]))
        line = learner_json('the local cluster', proc.stdout)
        line['wall'] = wall
        log('workers (local): %s' % json.dumps(line))
        check_worker_plane_line('the local cluster', line,
                                WORKERS_LOCAL['epochs'])
        if line['worker_processes'] != WORKERS_LOCAL['worker'][
                'num_parallel']:
            fail('the local cluster heard from %d worker processes'
                 % line['worker_processes'])
        left = processes_left(proc.stderr)
        if left:
            fail('worker or gather processes left after the run: %s' % left)
        models = os.path.join(tmp, 'models')
        last = WORKERS_LOCAL['epochs']
        for name in ['%d.ckpt' % e for e in range(1, last + 1)] + [
                'latest.ckpt', 'trainer_state.ckpt']:
            ok, reason = verify_checkpoint(os.path.join(models, name))
            if not ok or reason != 'ok':
                fail('local cluster checkpoint %s: %s' % (name, reason))
        _, from_flax = param_trees(make_env(LEARNER_CONFIG['env_args']).net())

        def params(name):
            with open(os.path.join(models, name), 'rb') as f:
                return from_flax(flax_msgpack.from_bytes(f.read()))
        first, final = params('1.ckpt'), params('%d.ckpt' % last)
        moved = max((final[k] - first[k]).abs().max().item() for k in first)
        if not moved > 0:
            fail('the local cluster\'s params did not move after epoch 1')
        log('workers (local): params moved %.3g (max abs) from 1.ckpt to '
            '%d.ckpt; fleet %s' % (moved, last, line['fleet']))
        log('workers (local): kernel launches: learner %s, worker '
            'processes %s' % (line['kernel_launches'],
                              line['worker_kernel_launches']))
        log('workers (local): %s' % worker_ply_line(line))
        side_by_side('the host learner (phase 5, batched generation) vs '
                     'the local worker cluster (6 workers)',
                     ('batched (5)', 'workers (9a)'), (learner, line))
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tail(path, n=60):
    with open(path, errors='replace') as f:
        return ''.join(f.readlines()[-n:])


def prom_values(text, name):
    """``{labels: value}`` of one metric in Prometheus text."""
    out = {}
    for l in text.splitlines():
        if l.startswith(name + ' ') or l.startswith(name + '{'):
            key, _, value = l.rpartition(' ')
            out[key[len(name):]] = float(value)
    return out


def scrape_after_kill(repo, port, host_log, server):
    """9(b) while it runs: once the chaos line is in the host's log, the
    learner's ``/metrics``, ``/statusz`` and ``--status`` until they show
    what the phase checks (the fleet's merge lands at an epoch's close).
    Returns the numbers it logs."""
    import urllib.request
    deadline = time.monotonic() + PHASE9_TIMEOUT
    while 'chaos: killing gather' not in open(host_log).read():
        if server.poll() is not None or time.monotonic() > deadline:
            fail('9(b): no gather was killed while the learner ran')
        time.sleep(0.5)
    base = 'http://127.0.0.1:%d' % port
    last = ''
    while True:
        if server.poll() is not None or time.monotonic() > deadline:
            fail('9(b): the learner ended before its exporter showed the '
                 'fleet and the card\'s memory; last scrape:\n%s'
                 % last[-3000:])
        t0 = time.monotonic()
        try:
            text = urllib.request.urlopen(base + '/metrics', timeout=5
                                          ).read().decode()
        except OSError as exc:
            last = str(exc)
            time.sleep(0.5)
            continue
        scrape_ms = 1e3 * (time.monotonic() - t0)
        last = text
        returned = prom_values(text, 'learner_episodes_returned_total')
        in_use = prom_values(text, 'device_mem_bytes_in_use').get(
            '{device="cuda:0"}', 0.0)
        limit = prom_values(text, 'device_mem_bytes_limit').get(
            '{device="cuda:0"}', 0.0)
        fleet = [l for l in text.splitlines()
                 if 'source="fleet"' in l and l.startswith(
                     ('worker_tasks_total', 'gather_uploads_total'))]
        status = json.loads(urllib.request.urlopen(
            base + '/statusz', timeout=5).read())
        perf = status.get('perf') or {}
        if returned.get('', 0) > 0 and 0 < in_use <= limit and fleet \
                and status.get('fleet_hosts') and perf.get('steady_state'):
            break
        time.sleep(0.5)
    if not status.get('progress'):
        fail('9(b): /statusz has no progress: %s' % status)
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch', '--status',
         '127.0.0.1:%d' % port], cwd=repo, capture_output=True, text=True,
        timeout=60)
    if proc.returncode != 0:
        fail('9(b): --status exited %d:\n%s%s' % (
            proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:]))
    for l in proc.stdout.splitlines():
        log('  --status: %s' % l)
    log('workers (remote): /metrics scraped in %.2f ms (%d lines): '
        'learner_episodes_returned_total %d, device_mem_bytes_in_use '
        '{device="cuda:0"} %.0f of %.0f, %d worker-host counters under '
        'source="fleet" (%s); /statusz progress %s, fleet hosts %s, perf '
        'steady %s, retraces %s' % (
            scrape_ms, len(text.splitlines()), returned[''], in_use, limit,
            len(fleet), fleet[0], status['progress'], status['fleet_hosts'],
            perf.get('steady_state'), perf.get('retraces')))
    return {'scrape_ms': scrape_ms, 'metrics_lines': len(text.splitlines()),
            'mem_in_use': in_use, 'mem_limit': limit,
            'fleet_series': len(fleet)}


def check_remote_telemetry(tmp, line, rows):
    """9(b) after its run: the trace chain across three processes, the
    host's gather-death dump, heartbeat_misses fired in the rows, no
    retrace. Returns the trace's numbers."""
    import glob
    from collections import defaultdict
    tel = line.get('telemetry') or {}
    if tel.get('retraces') != 0:
        fail('9(b): the learner counted %s retraces after warm-up (a CUDA '
             'graph captured or a kernel built in steady state)'
             % tel.get('retraces'))
    if not tel.get('trace'):
        fail('9(b): the learner collated no trace')
    with open(tel['trace']) as f:
        events = json.load(f)['traceEvents']
    by_id = defaultdict(lambda: defaultdict(set))
    for e in events:
        a = e.get('args') or {}
        for tid in ([a['trace_id']] if 'trace_id' in a else []) + list(
                a.get('trace_ids') or ()):
            by_id[tid][e['name']].add(e['pid'])
    linked = [t for t, names in by_id.items()
              if set(TRACE_CHAIN) <= set(names)
              and len(set().union(*(names[n] for n in TRACE_CHAIN))) >= 3]
    if not linked:
        fail('9(b): no trace id has all of %s from three processes (%d ids '
             'traced)' % (TRACE_CHAIN, len(by_id)))
    traced = sum(1 for e in events if 'trace_id' in (e.get('args') or {})
                 or (e.get('args') or {}).get('trace_ids'))
    dumps = glob.glob(os.path.join(tmp, 'blackbox', 'worker-host-*.json'))
    reasons = []
    for path in dumps:
        with open(path) as f:
            reasons.append(json.load(f).get('reason'))
    if 'gather-death' not in reasons:
        fail('9(b): the worker host left no gather-death dump (%s)'
             % reasons)
    fired = [r['epoch'] for r in rows
             if 'heartbeat_misses' in ((r.get('alerts') or {})
                                       .get('fired') or {})]
    if not fired:
        fail('9(b): no metrics row shows heartbeat_misses fired: %s'
             % [r.get('alerts') for r in rows])
    pids = set().union(*(by_id[linked[0]][n] for n in TRACE_CHAIN))
    log('workers (remote): trace %s: %d events, %d trace ids, %d linked '
        'through all five hops (%s: pids %s); %.2f traced events an '
        'episode; gather-death dump %s; heartbeat_misses fired by the rows '
        'of epochs %s; 0 retraces' % (
            os.path.basename(tel['trace']), len(events), len(by_id),
            len(linked), linked[0], sorted(pids),
            traced / max(1, line['episodes']),
            os.path.basename(dumps[reasons.index('gather-death')]), fired))
    return {'trace_events': len(events), 'trace_ids': len(by_id),
            'linked_ids': len(linked),
            'events_per_episode': traced / max(1, line['episodes'])}


def run_tool(repo, script, args, label):
    """``python scripts/<script> ARGS --json``: (exit code, its JSON)."""
    proc = subprocess.run([sys.executable, os.path.join('scripts', script)]
                          + list(args) + ['--json'], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    try:
        report = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        fail('%s: %s printed no JSON (exit %d):\n%s' % (
            label, script, proc.returncode, proc.stderr[-2000:]))
    return proc.returncode, report


def remote_tools(repo, tmp, host_out):
    """9(b) after its run: ``scripts/torch_trace_report.py`` on its trace
    directory and ``scripts/torch_postmortem.py`` on its worker host's
    blackbox directory, each exit 0; the postmortem names the killed
    gather among the dumps."""
    t0 = time.monotonic()
    rc, report = run_tool(repo, 'torch_trace_report.py',
                          [os.path.join(tmp, 'traces')], '9(b)')
    if rc != 0 or not report['complete_chains']:
        fail('9(b): torch_trace_report.py exited %d with %s complete '
             'chains' % (rc, report.get('complete_chains')))
    rc, post = run_tool(repo, 'torch_postmortem.py',
                        [os.path.join(tmp, 'blackbox')], '9(b)')
    killed = [int(m) for m in re.findall(r'chaos: killing gather (\d+)',
                                         host_out)]
    named = [d['context'].get('gather') for d in post['deaths']
             if d['reason'] == 'gather-death']
    if rc != 0 or not killed or killed[0] not in named:
        fail('9(b): torch_postmortem.py exited %d; killed gather %s, dumps '
             'name %s' % (rc, killed, named))
    seconds = time.monotonic() - t0
    log('workers (remote): torch_trace_report.py: %d events, %d chains '
        '(%d complete); torch_postmortem.py: %d dump(s), first failure %s '
        '(%s), gather %d among them; both tools %.2f s' % (
            report['events'], report['chains'], report['complete_chains'],
            post['dumps'], post['first_failure']['role'],
            post['first_failure']['reason'], killed[0], seconds))
    return {'report_chains': report['complete_chains'],
            'postmortem_dumps': post['dumps'], 'tools_s': seconds}


def phase_workers_remote(torch, repo):
    """Phase 9(b): ``--server`` and one worker host of REMOTE_WORKERS
    workers on the card over localhost TCP, on free ports, with a gather
    killed by the chaos drill. Each process writes to a file and leads a
    session of its own, so that a hang is killed whole and shown."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_remote_')
    procs = {}
    try:
        entry, data, tport = free_ports(3)
        metrics = os.path.join(tmp, 'metrics.jsonl')
        telemetry = dict(REMOTE_TELEMETRY,
                         trace_dir=os.path.join(tmp, 'traces'),
                         blackbox_dir=os.path.join(tmp, 'blackbox'))
        path = worker_plane_config(
            tmp, dict(WORKERS_REMOTE, telemetry=telemetry,
                      telemetry_port=tport, metrics_jsonl=metrics,
                      **PROFILE_SWITCHES,
                      fault_tolerance=dict(
                          WORKERS_REMOTE['fault_tolerance'],
                          heartbeat_interval=REMOTE_HEARTBEAT)),
            worker_args={'server_address': '127.0.0.1',
                         'num_parallel': REMOTE_WORKERS})
        env = {k: v for k, v in os.environ.items()
               if k not in TELEMETRY_ENV}
        env.update(HANDYRL_TPU_ENTRY_PORT=str(entry),
                   HANDYRL_TPU_DATA_PORT=str(data), PYTHONUNBUFFERED='1')
        logs = {k: (os.path.join(tmp, k + '.out'),
                    os.path.join(tmp, k + '.err'))
                for k in ('server', 'host')}
        cmds = {'server': ['handyrl_tpu_torch.train', '--config', path,
                           '--server'],
                'host': ['handyrl_tpu_torch.worker', '--config', path]}
        t0 = time.monotonic()
        for k in ('server', 'host'):
            with open(logs[k][0], 'w') as out, open(logs[k][1], 'w') as err:
                procs[k] = subprocess.Popen(
                    [sys.executable, '-m'] + cmds[k], cwd=repo, stdout=out,
                    stderr=err, start_new_session=True,
                    env=dict(env, HANDYRL_TPU_CHAOS=REMOTE_CHAOS)
                    if k == 'host' else env)
        deadline = time.monotonic() + PHASE9_TIMEOUT
        scraped = scrape_after_kill(repo, tport, logs['host'][0],
                                    procs['server'])
        for k in ('host', 'server'):
            try:
                procs[k].wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail('the remote pair did not finish within %d s; the '
                     'server:\n%s\n%s\nthe worker host:\n%s\n%s' % (
                         PHASE9_TIMEOUT, tail(logs['server'][0], 20),
                         tail(logs['server'][1]), tail(logs['host'][0]),
                         tail(logs['host'][1])))
        wall = time.monotonic() - t0
        with open(logs['server'][0]) as f:
            out = f.read()
        with open(logs['host'][0]) as f:
            host_out = f.read()
        with open(logs['host'][1]) as f:
            host_err = f.read()
        for l in out.splitlines():
            if l.startswith(('epoch', 'loss', 'updated model', 'fleet:')):
                log('  server: %s' % l)
        for l in host_out.splitlines():
            log('  worker host: %s' % l)
        for k in ('server', 'host'):
            if procs[k].returncode != 0:
                fail('the %s exited %d:\n%s' % (
                    k, procs[k].returncode, tail(logs[k][1])))
        line = learner_json('the training server', out)
        line['wall'] = wall
        log('workers (remote): %s' % json.dumps(line))
        check_worker_plane_line('the training server', line,
                                WORKERS_REMOTE['epochs'])
        if 'chaos: killing gather' not in host_out or \
                'worker host: 1 gather respawns' not in host_out:
            fail('the worker host\'s supervisor did not respawn a killed '
                 'gather:\n%s' % host_out[-2000:])
        fleet = line['fleet']
        log('workers (remote): gather killed and respawned; the ledger '
            're-issued %d task(s) (duplicates dropped %d, detached %d, '
            'hosts quarantined then readmitted %d, tasks withheld %d); '
            '%d episodes, each counted once; %.1f s wall' % (
                fleet['reissued'], fleet['duplicates_dropped'],
                fleet['detached'], fleet['readmitted'], fleet['withheld'],
                line['episodes'], wall))
        log('workers (remote): %s' % worker_ply_line(line))
        left = processes_left(host_err)
        if left:
            fail('worker or gather processes left after the run: %s' % left)
        with open(metrics) as f:
            rows = [json.loads(l) for l in f if l.strip()]
        line['telemetry_checks'] = dict(
            scraped, **check_remote_telemetry(tmp, line, rows),
            **remote_tools(repo, tmp, host_out))
        line['profiled_kernels'] = check_profile('9(b) the training server',
                                                 line)
        return line
    finally:
        for proc in procs.values():   # every process a session started
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------- phase 10: network battles

# The battle port is the JAX package's network_match_port, which the CLI
# fixes: the phase fails naming it when another process holds it.
BATTLE_PORT = 9876
GEESE_ENV = {'env': 'HungryGeese', 'torus_impl': 'pallas'}
TTT_ENV = {'env': 'TicTacToe'}
# (a) --eval-server GAMES PROCS on Hungry Geese: one group of four client
# connections, each a child on the card; (b) TicTacToe with two spawned
# runners, each handed its group's sockets, and two client programs
GEESE_BATTLE = (8, 1)
TTT_BATTLE = (20, 2)
SPEC_GAMES = 8           # (c) --eval registry:// and serve:// GAMES 1
# the seeded full-width GeeseNet: its greedy geese live 40 plies on the
# CPU's plain trunk (most seeds' die within a few, a weak test of the wire)
NETWORK_NET_SEED = SEED + 11
# serve:// against the .ckpt: the service's engine batches rows into other
# buckets, so the heads' products may sum in other orders (about 1e-6 at
# full width); registry:// must equal the .ckpt bit for bit
SERVE_TOL = 1e-4
PHASE10_TIMEOUT = 120    # each process
CHILD_LINE = r'client child \(pid (\d+)\): (\{.*\})'
# the pairwise-rank scores a Hungry Geese game can give a goose
GEESE_SCORES = (-1.0, -2 / 3, -1 / 3, 0.0, 1 / 3, 2 / 3, 1.0)


def port_is_free(port):
    if not port_free(port):
        fail('port %d, the network battle\'s fixed port, is taken: phase '
             '10 needs it free' % port)


def port_free(port):
    import socket
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind(('', port))
        return True
    except OSError:
        return False
    finally:
        s.close()


def wait_listening(port, proc, timeout):
    """Until a socket listens on ``port`` (the kernel's tables: a probe
    connection would be accepted as a client); fails if ``proc`` (None for
    an in-process server) exits first."""
    needle = ':%04X ' % port
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for table in ('/proc/net/tcp', '/proc/net/tcp6'):
            with open(table) as f:
                if any(needle in l and l.split()[3] == '0A' for l in f):
                    return
        if proc is not None and proc.poll() is not None:
            fail('the battle server exited %d before it listened'
                 % proc.returncode)
        time.sleep(0.05)
    fail('nothing listened on port %d within %.0f s' % (port, timeout))


class Sessions:
    """Processes of the CLI, each leading a session of its own with its
    output in files, so that a hang or a failure is killed whole (spawned
    children included) and shown."""

    def __init__(self, repo, tmp):
        self.repo, self.tmp, self.procs = repo, tmp, {}

    def start(self, name, args, stdout=None):
        out = open(os.path.join(self.tmp, name + '.out'), 'w') \
            if stdout is None else stdout
        with open(os.path.join(self.tmp, name + '.err'), 'w') as err:
            proc = subprocess.Popen(
                [sys.executable, '-m', 'handyrl_tpu_torch'] + args,
                cwd=self.repo, stdout=out, stderr=err,
                start_new_session=True)
        if stdout is None:
            out.close()
        self.procs[name] = proc
        return proc

    def text(self, name, which='out'):
        with open(os.path.join(self.tmp, '%s.%s' % (name, which)),
                  errors='replace') as f:
            return f.read()

    def wait(self, names, timeout=PHASE10_TIMEOUT):
        """Wait for ``names`` to exit 0; fails naming the first that hangs
        or fails, with its error tail."""
        deadline = time.monotonic() + timeout
        for name in names:
            try:
                self.procs[name].wait(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail('%s did not finish within %d s:\n%s' % (
                    name, timeout, self.text(name, 'err')[-3000:]))
        for name in names:
            if self.procs[name].returncode != 0:
                fail('%s exited %d:\n%s' % (
                    name, self.procs[name].returncode,
                    self.text(name, 'err')[-3000:]))

    def kill(self):
        for proc in self.procs.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()


def client_children(sessions, names):
    """The ``client child`` lines of the client programs ``names`` by pid;
    fails if a child outlived its program (the client joins them)."""
    import re
    children = {}
    for name in names:
        for pid, body in re.findall(CHILD_LINE, sessions.text(name)):
            children[int(pid)] = json.loads(body)
    alive = [p for p in children if os.path.exists('/proc/%d' % p)]
    if alive:
        fail('client children left after their programs exited: %s' % alive)
    return children


def sum_counts(dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def network_battle(sessions, label, config, ckpt, games, procs, clients,
                   agents):
    """``--eval-server GAMES PROCS`` and ``clients`` programs of
    ``--eval-client CKPT 127.0.0.1`` on the card, with no --device: every
    process exits 0, the report is the JAX format with every game counted
    for every agent, and the children played their groups' games. Returns
    (the children's lines by pid, wall seconds)."""
    port_is_free(BATTLE_PORT)
    t0 = time.monotonic()
    server = sessions.start(label + '_server', [
        '--eval-server', str(games), str(procs), '--config', config])
    wait_listening(BATTLE_PORT, server, 60)
    names = ['%s_client%d' % (label, i) for i in range(clients)]
    for name in names:
        sessions.start(name, ['--eval-client', ckpt, '127.0.0.1',
                              '--config', config])
    sessions.wait([label + '_server'] + names)
    wall = time.monotonic() - t0
    out = sessions.text(label + '_server')
    tallies, report = parse_report(out, games, procs, label + ' server')
    for line in report:
        log('  %s server: %s' % (label, line))
    for a in range(agents):
        if sum(tallies.get(a, {}).get('total', ({}, 0))[0].values()) \
                != games:
            fail('%s: agent %d\'s report counts %s games, not %d' % (
                label, a, tallies.get(a), games))
    if 'network match server mode' not in out:
        fail('%s: the server did not print its mode line' % label)
    children = client_children(sessions, names)
    if len(children) != procs * agents:
        fail('%s: %d client children reported, %d expected (%d groups of '
             '%d)' % (label, len(children), procs * agents, procs, agents))
    if sum(len(c['outcomes']) for c in children.values()) != games * agents:
        fail('%s: the children saw %d outcomes for %d games of %d seats'
             % (label, sum(len(c['outcomes']) for c in children.values()),
                games, agents))
    for pid, c in children.items():
        if not c['device'].startswith('cuda'):
            fail('%s: client child %d ran on %s' % (label, pid, c['device']))
    return children, wall


def battle_rates(label, games, children, wall, inline_s):
    play = max(c['play_seconds'] for c in children.values())
    start = sorted(c['start_seconds'] for c in children.values())
    actions = sum(c['actions'] for c in children.values())
    log('%s: %d games in %.2f s of play (%.3f games/s; the slowest child\'s '
        'play seconds), %.2f s wall with the processes\' start; --eval '
        'inline of the same checkpoint in every seat %.2f s (%.3f games/s); '
        '%d actions answered; children\'s start %.2f-%.2f s (torch, a CUDA '
        'context, the model)' % (
            label, games, play, games / play, wall, inline_s,
            games / inline_s, actions, start[0], start[-1]))
    return {'games': games, 'play_seconds': play, 'wall': wall,
            'games_per_s': games / play, 'inline_seconds': inline_s,
            'inline_games_per_s': games / inline_s, 'actions': actions,
            'start_seconds': start}


def eval_inline_seconds(env_args, ckpt, games):
    """The inline tournament of ``--eval`` (one runner, ``evaluate_mp``)
    in this process on the card, the checkpoint in every seat: the seconds
    of its games, the agents loaded before."""
    import contextlib
    import io
    from handyrl_tpu_torch import evaluation
    from handyrl_tpu_torch.agent import Agent
    from handyrl_tpu_torch.environment import make_env
    env = make_env(env_args)
    agents = [Agent(evaluation.load_model(ckpt, env, 'cuda'))
              for _ in env.players()]
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()):
        t = evaluation.evaluate_mp(env, agents, None, env_args,
                                   {'default': {}}, 1, games, SEED)
    seconds = time.monotonic() - t0
    if sum(t.overall[0].values()) != games:
        fail('the inline evaluation counted %s' % t.overall[0])
    return seconds


def recording(env, plies):
    step = env.step

    def recorded(moves):
        plies.append(dict(moves))
        return step(moves)
    env.step = recorded
    return env


def wire_equality(sessions, make_env, config, ckpt):
    """(a'): one Geese match from a fixed ``random`` seed, the server in a
    thread of this process and the four agents in spawned clients on the
    card, against ``exec_match`` of the same four card agents here: the
    same moves every ply and the same outcome. Times each command's round
    trip over localhost."""
    import random
    import threading
    from handyrl_tpu_torch import evaluation
    from handyrl_tpu_torch.agent import Agent
    model = evaluation.load_model(ckpt, make_env(GEESE_ENV), 'cuda')
    random.seed(SEED)
    want = []
    env = recording(make_env(GEESE_ENV), want)
    want_result = evaluation.exec_match(
        env, {p: Agent(model) for p in env.players()})['result']

    port_is_free(BATTLE_PORT)
    got, trips, box = [], {}, {}

    def server():
        try:
            group = evaluation.network_match_acception(
                1, GEESE_ENV, 4, BATTLE_PORT)[0]
            for agent in group:
                timed = agent._call

                def call(command, *args, timed=timed):
                    t0 = time.perf_counter()
                    reply = timed(command, *args)
                    trips.setdefault(command, []).append(
                        time.perf_counter() - t0)
                    return reply
                agent._call = call
            random.seed(SEED)
            env = recording(make_env(GEESE_ENV), got)
            box['result'] = evaluation.exec_network_match(
                env, {p: group[i] for i, p in enumerate(env.players())}
            )['result']
            for agent in group:
                agent.conn.close()
        except BaseException as exc:   # reported by the main thread
            box['error'] = exc
    thread = threading.Thread(target=server, daemon=True)
    thread.start()
    wait_listening(BATTLE_PORT, None, 60)
    names = ['wire_client%d' % i for i in range(4)]
    for name in names:
        sessions.start(name, ['--eval-client', ckpt, '127.0.0.1',
                              '--config', config])
    thread.join(timeout=PHASE10_TIMEOUT)
    if thread.is_alive() or 'error' in box:
        fail('(a\') the in-process server did not finish: %r'
             % box.get('error'))
    sessions.wait(names)
    children = client_children(sessions, names)
    if got != want or box['result'] != want_result:
        first = next((i for i, (g, w) in enumerate(zip(got, want))
                      if g != w), min(len(got), len(want)))
        fail('(a\') the network match differs from exec_match from ply %d '
             '(%d against %d plies; outcomes %s against %s)' % (
                 first, len(got), len(want), box['result'], want_result))
    log('(a\') network match == exec_match of the same four card agents: '
        '%d plies, the same moves every ply, outcome %s' % (
            len(want), want_result))
    # the first update of each seat waits for its child's start (spawned
    # after env_args): medians and tails, not means
    ms = {}
    for k, v in trips.items():
        v = sorted(v)
        ms[k] = {'n': len(v), 'p50': 1e3 * v[len(v) // 2],
                 'p99': 1e3 * v[min(len(v) - 1, int(0.99 * len(v)))],
                 'max': 1e3 * v[-1]}
    log('(a\') round trip per seat over localhost (host clock, this '
        'process): %s' % '; '.join(
            '%s p50 %.3f ms, p99 %.3f ms, max %.1f ms (x %d)' % (
                k, m['p50'], m['p99'], m['max'], m['n'])
            for k, m in sorted(ms.items())))
    return {'plies': len(want), 'round_trip_ms': ms, 'children': children}


def check_geese_children(label, children):
    """Each child launched K1 (its agent's forward on the card) and no
    other kernel; the four seats' outcomes of each game are scores the env
    gives and sum to 0."""
    for pid, c in children.items():
        counts = c['kernel_launches']
        if not counts['geese_trunk'] > 0 or any(
                n for k, n in counts.items() if k != 'geese_trunk'):
            fail('%s: client child %d launched %s (K1 and nothing else '
                 'expected)' % (label, pid, counts))
        if any(min(abs(o - s) for s in GEESE_SCORES) > 1e-9
               for o in c['outcomes']):
            fail('%s: client child %d saw outcomes %s' % (label, pid,
                                                         c['outcomes']))
    for k, game in enumerate(zip(*(c['outcomes']
                                   for c in children.values()))):
        if abs(sum(game)) > 1e-9:
            fail('%s: game %d\'s outcomes %s do not sum to 0'
                 % (label, k, game))


def check_zero_sum_pairs(label, children):
    """TicTacToe: the children pair into groups whose outcomes sum to 0
    game by game, each outcome a win, a draw or a loss."""
    lists = [c['outcomes'] for c in children.values()]
    if any(o not in (-1.0, 0.0, 1.0) for l in lists for o in l):
        fail('%s: outcomes other than -1, 0 and 1: %s' % (label, lists))
    while lists:
        a = lists.pop()
        b = next((l for l in lists if len(l) == len(a)
                  and all(x + y == 0 for x, y in zip(a, l))), None)
        if b is None:
            fail('%s: no child\'s outcomes cancel %s' % (label, a))
        lists.remove(b)


def model_specs(sessions, make_env, torch, config, ckpt, root, service):
    """(c): ``--eval registry://ROOT/geese@champion`` and ``--eval
    serve://127.0.0.1:PORT/geese@champion`` (SPEC_GAMES games, 1 process,
    both at once), the service's K1 launches read through its ``status``
    admin op just before and just after; then in this process the
    registry:// model's outputs against the .ckpt's bit for bit and the
    serve:// model's within SERVE_TOL, and a ply's time of each."""
    import numpy as np
    from handyrl_tpu_torch import evaluation
    from handyrl_tpu_torch.serving.client import ServiceClient
    ready = read_ready_line(service, timeout=120)
    if ready['device'] != 'cuda':
        fail('the service runs on %r, not the card' % ready['device'])
    client = ServiceClient('127.0.0.1', ready['port'], timeout=120)
    try:
        before = client.status()['kernel_launches']
        if any(before.values()):
            fail('the service\'s counts before serve:// are not 0: %s'
                 % before)
        specs = {'registry': 'registry://%s/geese@champion' % root,
                 'serve': 'serve://127.0.0.1:%d/geese@champion'
                          % ready['port']}
        t0 = time.monotonic()
        for name, spec in specs.items():
            sessions.start('eval_' + name, ['--eval', spec, str(SPEC_GAMES),
                                            '1', '--config', config])
        sessions.wait(['eval_' + name for name in specs])
        wall = time.monotonic() - t0
        status = client.status()
        launches = status['kernel_launches']
    finally:
        client.close()
    for name in specs:
        tallies, _ = parse_report(sessions.text('eval_' + name), SPEC_GAMES,
                                  1, '--eval ' + name + '://')
        if sum(tallies[0]['total'][0].values()) != SPEC_GAMES:
            fail('--eval %s:// counted %s' % (name, tallies[0]))
    if not launches.get('geese_trunk', 0) > 0 or any(
            n for k, n in launches.items() if k != 'geese_trunk'):
        fail('the service under serve:// launched %s (K1 and nothing else '
             'expected)' % launches)
    log('(c) --eval registry:// and serve:// (%d games each, at once) in '
        '%.2f s; the service answered %d requests in %d batches, kernel '
        'launches %s' % (SPEC_GAMES, wall, status['engine_requests'],
                         status['engine_batches'], launches))

    env = make_env(GEESE_ENV)
    local = evaluation.load_model(ckpt, env, 'cuda')
    registry = evaluation.load_model(specs['registry'], env, 'cuda')
    served = evaluation.load_model(specs['serve'], env)
    try:
        boards = game_observations(make_env, 24, SEED)
        worst = 0.0
        for obs in boards:
            want = local.inference(obs)
            got = registry.inference(obs)
            for k in want:
                if not np.array_equal(got[k], want[k]):
                    fail('registry:// %s differs from the .ckpt\'s' % k)
            rep = served.inference(obs)
            for k in ('policy', 'value'):
                worst = max(worst, float(np.abs(np.asarray(rep[k])
                                                - want[k]).max()))
        if not worst <= SERVE_TOL:
            fail('serve:// outputs differ from the .ckpt\'s by %.3g (tol '
                 '%.0e)' % (worst, SERVE_TOL))
        reps = 50

        def ply_ms(model):
            t0 = time.perf_counter()
            for _ in range(reps):
                for obs in boards[:4]:
                    model.inference(obs)
            return 1e3 * (time.perf_counter() - t0) / reps
        local_ms, serve_ms = ply_ms(local), ply_ms(served)
    finally:
        served.close()
    log('(c) registry:// == .ckpt bit for bit on %d boards; serve:// within '
        '%.3g of it (tol %.0e); a ply of four forwards: .ckpt in this '
        'process %.3f ms, serve:// %.3f ms (host clock, one after another)'
        % (len(boards), worst, SERVE_TOL, local_ms, serve_ms))
    return {'launches': launches, 'serve_err': worst,
            'local_ply_ms': local_ms, 'serve_ply_ms': serve_ms,
            'eval_wall': wall}


def phase_network(torch, repo, make_env):
    """Phase 10: network battles and the model specs through ``python -m
    handyrl_tpu_torch``, with no --device (the card is the default)."""
    from handyrl_tpu_torch.model import ModelWrapper, params_bytes
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
    from handyrl_tpu_torch.serving.registry import ModelRegistry
    port_is_free(BATTLE_PORT)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_network_')
    sessions = Sessions(repo, tmp)
    try:
        geese = GeeseNet(filters=WIDTH['filters'], layers=WIDTH['layers'],
                         torus_impl='pallas', generator=torch.Generator()
                         .manual_seed(NETWORK_NET_SEED))
        torch.manual_seed(NETWORK_NET_SEED)
        ttt = SimpleConv2dModel()
        paths = {}
        for name, module in (('geese', geese), ('ttt', ttt)):
            paths[name] = os.path.join(tmp, name + '.ckpt')
            with open(paths[name], 'wb') as f:
                f.write(params_bytes(module))
        root = os.path.join(tmp, 'registry')
        ModelRegistry(root).publish(
            'geese', snapshot=ModelWrapper(geese, 'cpu').snapshot(),
            version=1, promote=True)
        configs = {}
        for name, cfg in (
                ('geese', {'env_args': GEESE_ENV}),
                ('ttt', {'env_args': TTT_ENV}),
                ('serve', {'env_args': GEESE_ENV, 'train_args': {
                    'serving': {'port': 0, 'registry_dir': root}}})):
            configs[name] = os.path.join(tmp, name + '.json')
            with open(configs[name], 'w') as f:
                json.dump(cfg, f)
        # (c)'s service starts first: its start overlaps the battles
        service = sessions.start('service', ['--serve', '--config',
                                             configs['serve']],
                                 stdout=subprocess.PIPE)

        log('(a) Hungry Geese: --eval-server %d %d, four --eval-client '
            'programs' % GEESE_BATTLE)
        a_children, a_wall = network_battle(
            sessions, 'geese', configs['geese'], paths['geese'],
            *GEESE_BATTLE, clients=4, agents=4)
        check_geese_children('(a)', a_children)
        a = battle_rates('(a) Hungry Geese', GEESE_BATTLE[0], a_children,
                         a_wall, eval_inline_seconds(
                             GEESE_ENV, paths['geese'], GEESE_BATTLE[0]))
        a['launches'] = sum_counts(c['kernel_launches']
                                   for c in a_children.values())

        log('(a\') the wire against the in-process match')
        wire = wire_equality(sessions, make_env, configs['geese'],
                             paths['geese'])
        check_geese_children('(a\')', wire['children'])
        wire['launches'] = sum_counts(c['kernel_launches']
                                      for c in wire['children'].values())

        log('(b) TicTacToe: --eval-server %d %d, two --eval-client programs'
            % TTT_BATTLE)
        b_children, b_wall = network_battle(
            sessions, 'ttt', configs['ttt'], paths['ttt'], *TTT_BATTLE,
            clients=2, agents=2)
        check_zero_sum_pairs('(b)', b_children)
        b = battle_rates('(b) TicTacToe', TTT_BATTLE[0], b_children, b_wall,
                         eval_inline_seconds(TTT_ENV, paths['ttt'],
                                             TTT_BATTLE[0]))
        b['launches'] = sum_counts(c['kernel_launches']
                                   for c in b_children.values())

        log('(c) registry:// and serve:// specs')
        c = model_specs(sessions, make_env, torch, configs['geese'],
                        paths['geese'], root, service)
        service.send_signal(signal.SIGTERM)
        try:
            rc = service.wait(timeout=60)
        except subprocess.TimeoutExpired:
            fail('the service did not exit within 60 s of SIGTERM')
        if rc != 75:
            fail('the service exited %d after SIGTERM, expected 75' % rc)
        return {'geese': a, 'wire': wire, 'ttt': b, 'specs': c}
    finally:
        sessions.kill()
        shutil.rmtree(tmp, ignore_errors=True)


# -------------------------- phase 11: the other device branches, the export

# (a) the split path at phase 5's config: rollout chunks on the card
# (DeviceGenerator), episodes spliced on the host, the host trainer
SPLIT_EPOCHS = 2
SPLIT = {'device_generation': True, 'device_chunk_steps': 16,
         'minimum_episodes': 128, 'update_episodes': 128,
         'epochs': SPLIT_EPOCHS}
# (b) the threaded replay trainer with device ingest at phase 6's
# north-star config, a checkpoint of phase 6 among the eval opponents
REPLAY_EPOCHS = 4        # 8 until phase 17 needed the time (PERF.md §4)
REPLAY_K = 8
REPLAY_REUSE_CAP = 16.0
REPLAY = {'fused_pipeline': False, 'replay_fused_steps': REPLAY_K,
          'max_sample_reuse': REPLAY_REUSE_CAP, 'epochs': REPLAY_EPOCHS,
          'checkpoint_interval': 1}
# (c) the host push on TicTacToe at tictactoe.json's widths
HOST_PUSH_EPOCHS = 2     # 3 until phase 17 needed the time (PERF.md §4)
HOST_PUSH = {'device_replay': True, 'device_ingest': False,
             'replay_fused_steps': REPLAY_K, 'minimum_episodes': 200}
EXPORT_TOL = 1e-4        # fp32, the card's program against the card's net
EXPORT_BOARDS = 32
OP_NS = (1, 8)           # the serving forwards: one seat, the 8-row bucket
OP_REPS = 300


def run_train_cli(repo, cfg, tmp, label, timeout=600):
    """``python -m handyrl_tpu_torch.train --config`` on ``cfg`` (no
    --device: the card is the default), its model dir and metrics rows in
    ``tmp``: its JSON line (with the wall as 'wall') and its stdout."""
    cfg = json.loads(json.dumps(cfg))
    cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
    cfg['train_args']['metrics_jsonl'] = os.path.join(tmp, 'metrics.jsonl')
    path = os.path.join(tmp, 'config.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             path], cwd=repo, capture_output=True, text=True,
            timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        fail('%s did not finish within %d s:\n%s' % (
            label, timeout, (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(('epoch', 'win rate', 'loss', 'device ingest',
                            'updated model')):
            log('  %s: %s' % (label, line))
    if proc.returncode != 0:
        fail('%s exited %d:\n%s' % (label, proc.returncode,
                                    proc.stderr[-4000:]))
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    if len(lines) != 1:
        fail('%s printed %d JSON lines' % (label, len(lines)))
    line = json.loads(lines[0])
    line['wall'] = wall
    return line, proc.stdout


def check_branch(label, line, epochs, path, want):
    """A device branch's run: its epochs with finite losses, the branch it
    took, no failed trainer, and each kernel of ``want`` ({launch path:
    kernels}) launched; returns its rates as a dict."""
    import math
    if line['failed'] or line['epochs'] != epochs:
        fail('%s trained %s epochs (failed: %s)' % (
            label, line['epochs'], line['failed_reason']))
    if line.get('device_path') != path:
        fail('%s took the %s branch, not %s' % (label,
                                                line.get('device_path'),
                                                path))
    if not (line['losses'] and all(math.isfinite(v)
                                   for v in line['losses'].values())):
        fail('%s reports non-finite losses: %s' % (label, line['losses']))
    by_path = line['kernel_launches']
    for where, kernels in want.items():
        for k in kernels:
            if not by_path.get(where, {}).get(k, 0) > 0:
                fail('%s: %s never launched %s (%s)' % (label, where, k,
                                                         by_path))
    wanted = {(w, k) for w, ks in want.items() for k in ks}
    extra = {(w, k): n for w, c in by_path.items() for k, n in c.items()
             if n and (w, k) not in wanted}
    if extra:
        fail('%s launched kernels off its path: %s' % (label, extra))
    trainer_s = line['trainer_seconds'] or 0.0
    rates = {
        'episodes_per_s': line['episodes_per_s'],
        'trajectories_per_s': line['trajectories_per_s'],
        'update_steps_per_s': line['update_steps_per_s'],
        'trainer_wait_share': (line['trainer_batch_wait_seconds'] / trainer_s
                               if trainer_s else None),
        'wall': line['wall']}
    log('%s: %s; kernel launches by path %s; %s' % (
        label, json.dumps({k: v for k, v in rates.items()}), by_path,
        nvidia_smi_line()))
    return rates


def check_reuse_rows(label, rows, cap, per_dispatch):
    """Every row's samples drawn within cap x windows ingested plus one
    dispatch (the one an epoch waiting to close may take)."""
    for r in rows:
        drawn, ingested = (r['replay_samples_drawn'],
                           r['replay_windows_ingested'])
        if drawn > cap * ingested + per_dispatch:
            fail('%s: epoch %d drew %d samples from %d windows (cap %g)'
                 % (label, r['epoch'], drawn, ingested, cap))
    last = rows[-1]
    log('%s: %d samples drawn per %d windows ingested (%.2f a window, cap '
        '%g)' % (label, last['replay_samples_drawn'],
                 last['replay_windows_ingested'],
                 last['replay_samples_drawn']
                 / max(1, last['replay_windows_ingested']), cap))


def phase_split(torch, repo):
    """Phase 11(a)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_split_')
    try:
        cfg = json.loads(json.dumps(LEARNER_CONFIG))
        cfg['train_args'].update(SPLIT)
        line, _ = run_train_cli(repo, cfg, tmp, 'split')
        rates = check_branch('split', line, SPLIT_EPOCHS, 'split', {
            'generation': ('geese_trunk',), 'evaluation': ('geese_trunk',),
            'training': ('geese_trunk', 'geese_trunk_bwd', 'td_lambda')})
        log('split: %d generator dispatches (%d-ply chunks), %d eval '
            'dispatches, loop host seconds %s' % (
                line['generator_dispatches'], SPLIT['device_chunk_steps'],
                line['eval_dispatches'], line['loop_seconds']))
        return {'line': line, 'rates': rates}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_replay(torch, repo, opponent_ckpt):
    """Phase 11(b)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_replay_')
    try:
        cfg = json.loads(json.dumps(FUSED_CONFIG))
        cfg['train_args'].update(REPLAY)
        cfg['train_args']['eval'] = {'opponent': ['random', opponent_ckpt]}
        line, out = run_train_cli(repo, cfg, tmp, 'replay')
        if 'device ingest: windows assembled on device (solo mode)' \
                not in out:
            fail('the threaded replay trainer did not take the device '
                 'ingest')
        rates = check_branch('replay', line, REPLAY_EPOCHS, 'ingest', {
            'generation': ('geese_trunk',), 'evaluation': ('geese_trunk',),
            'training': ('geese_trunk', 'geese_trunk_bwd', 'vtrace')})
        replay = line['replay']
        train = line['kernel_launches'].get('training', {})
        if train.get('vtrace') != line['steps_at_exit'] or \
                line['steps_at_exit'] % REPLAY_K:
            fail('replay: %s V-trace launches in %d steps of %d a dispatch'
                 % (train.get('vtrace'), line['steps_at_exit'], REPLAY_K))
        rows = read_metrics(os.path.join(tmp, 'metrics.jsonl'))
        check_reuse_rows('replay', rows, REPLAY_REUSE_CAP,
                         REPLAY_K * cfg['train_args']['batch_size'])
        games = sum(r.get('eval_opponents', {}).get(opponent_ckpt, {})
                    .get('games', 0) for r in rows)
        if not games > 0:
            fail('replay: the device evaluator played no game against the '
                 'checkpoint opponent')
        log('replay: %s; the checkpoint opponent played %d games on the '
            'card; eval opponents of the last rows %s' % (
                json.dumps(replay), games,
                [r.get('eval_opponents') for r in rows[-2:]]))
        rates['samples_per_window'] = replay['sample_reuse']
        return {'line': line, 'rates': rates}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_host_push(torch, repo):
    """Phase 11(c)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_host_push_')
    try:
        cfg = quick_config(repo, HOST_PUSH, HOST_PUSH_EPOCHS)
        line, _ = run_train_cli(repo, cfg, tmp, 'host push')
        rates = check_branch('host push', line, HOST_PUSH_EPOCHS,
                             'host_push', {'training': ('td_lambda',)})
        replay = line['replay']
        if not (replay['windows_ingested'] > 0
                and replay['samples_drawn'] == line['steps_at_exit']
                * line['batch_size']):
            fail('host push: %s' % replay)
        log('host push: %s' % json.dumps(replay))
        rates['samples_per_window'] = replay['sample_reuse']
        return {'line': line, 'rates': rates}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


EXPORT_CHECK = r"""
import json, sys, time
import numpy as np
import torch
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.evaluation import ExportedModel, load_model
from handyrl_tpu_torch.model import fp32_on_card
from handyrl_tpu_torch.ops import kernel_launches, reset_kernel_launches
fp32_on_card(torch.device('cuda'))
pt2, ckpt, boards = sys.argv[1:4]
obs = np.load(boards)
t0 = time.monotonic()
model = ExportedModel(pt2)            # the card by default
model.inference(obs[0])
load_s = time.monotonic() - t0
ref = load_model(ckpt, make_env({'env': 'HungryGeese',
                                 'torus_impl': 'pallas'}))
ref.inference(obs[0])
reset_kernel_launches()
got = [model.inference(o) for o in obs]
launches = kernel_launches()
want = [ref.inference(o) for o in obs]
err = max(float(np.abs(g[k] - w[k]).max()) for g, w in zip(got, want)
          for k in w)
finite = all(np.isfinite(g[k]).all() for g in got for k in g)

def per_call_ms(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3

ms = [per_call_ms(lambda: model.inference(obs[0])),
      per_call_ms(lambda: ref.inference(obs[0]))]
ms += [per_call_ms(lambda: ref.inference(obs[0])),
       per_call_ms(lambda: model.inference(obs[0]))]
print(json.dumps({'device': torch.cuda.get_device_name(0), 'err': err,
                  'finite': finite, 'launches': launches,
                  'inferences': len(obs), 'load_seconds': load_s,
                  'exported_ms': (ms[0] + ms[3]) / 2,
                  'checkpoint_ms': (ms[1] + ms[2]) / 2}))
"""


def op_checks(torch, GeeseNet):
    """K1's registered operator on the card: held to the plain version at
    N in OP_NS, and a serving forward's latency (host clock, the net's
    no-grad forward and a synchronise, as a served request waits for it)
    with the operator against the direct wrapper call it replaced (the
    net's no-grad trunk before the operator), in turns, the median of OP_REPS
    calls a turn."""
    import numpy as np
    from handyrl_tpu_torch.models import geese as geese_mod
    from handyrl_tpu_torch.ops import geese_trunk
    net, weights = trunk_net(torch, GeeseNet)
    net.torus_impl = 'pallas'
    gen = torch.Generator().manual_seed(SEED + 21)
    real = geese_mod.trunk_serve
    rows = {}
    for n in OP_NS:
        x = torch.rand((n, 7, 11, WIDTH['cin']), generator=gen).cuda()
        obs = torch.rand((n, 17, 7, 11), generator=gen).cuda()
        with torch.no_grad():
            got = torch.ops.handyrl_tpu_torch.geese_trunk(
                x, *weights, WIDTH['groups'], geese_trunk.EPS)
            want = geese_trunk.trunk_forward_reference(x, *weights,
                                                       WIDTH['groups'])
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= TOL):
            fail('the operator\'s CUDA route disagrees with the plain '
                 'version at N=%d: max abs err %.3g (tol %.0e)'
                 % (n, err, TOL))

        def latency_ms(fn):
            out = []
            with torch.no_grad():
                for _ in range(OP_REPS + 10):
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    out.append((time.perf_counter() - t) * 1e3)
            return float(np.median(out[10:]))
        calls = {'direct': lambda: geese_trunk.trunk_forward(
                     x, *weights, groups=WIDTH['groups']),
                 'op': lambda: geese_trunk.trunk_serve(
                     x, *weights, groups=WIDTH['groups'])}
        t = {}
        try:
            for form in ('direct', 'op', 'op', 'direct') * 2:
                geese_mod.trunk_serve = (real if form == 'op'
                                         else geese_trunk.trunk_forward)
                t.setdefault('call_' + form, []).append(
                    latency_ms(calls[form]))
                t.setdefault('forward_' + form, []).append(
                    latency_ms(lambda: net(obs)))
        finally:
            geese_mod.trunk_serve = real
        row = {k: float(np.mean(v)) for k, v in t.items()}
        row['max_abs_err'] = err
        row['forward_ratio'] = row['forward_op'] / row['forward_direct']
        rows[n] = row
        log('op N=%d: max abs err vs plain %.3g; latency ms (median of %d, '
            'mean of 4 turns): the trunk direct %.4f, op %.4f; the net\'s '
            'serving forward direct %.4f, op %.4f (x%.3f) (%s)' % (
                n, err, OP_REPS, row['call_direct'], row['call_op'],
                row['forward_direct'], row['forward_op'],
                row['forward_ratio'], nvidia_smi_line()))
    return rows


def export_program(repo, ckpt, pt2):
    """Phase 11(d)'s export of ``ckpt`` to ``pt2`` on the CPU (a process
    of its own, beside 11(a)-(c)); its seconds."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.join('scripts', 'torch_export_model.py'),
         'HungryGeese', ckpt, pt2], cwd=repo, capture_output=True,
        text=True, timeout=300)
    log('export: %s' % ' | '.join(proc.stdout.strip().splitlines()))
    if proc.returncode != 0 or 'K1 operator in the graph: True' \
            not in proc.stdout:
        fail('the export failed (exit %d):\n%s' % (proc.returncode,
                                                    proc.stderr[-3000:]))
    return time.monotonic() - t0


def phase_export(torch, repo, GeeseNet, make_env, ckpt, pt2, export_s):
    """Phase 11(d): the exported program on the card against the
    checkpoint, and the operator's checks."""
    import numpy as np
    tmp = tempfile.mkdtemp(prefix='chip_smoke_export_')
    try:
        boards = os.path.join(tmp, 'boards.npy')
        np.save(boards, np.stack(game_observations(make_env, EXPORT_BOARDS,
                                                   SEED + 23)))
        proc = subprocess.run(
            [sys.executable, '-c', EXPORT_CHECK, pt2, ckpt, boards],
            cwd=repo, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            fail('the exported program did not run on the card:\n%s'
                 % proc.stderr[-3000:])
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        log('export: %.1f s to export on the CPU, %d bytes; on the card in '
            'a fresh process: %s (%s)' % (export_s, os.path.getsize(pt2),
                                         json.dumps(line), nvidia_smi_line()))
        if not line['finite'] or line['err'] > EXPORT_TOL:
            fail('the exported program disagrees with the checkpoint on the '
                 'card: max abs err %.3g (tol %.0e)' % (line['err'],
                                                        EXPORT_TOL))
        k = line['launches']
        if k.get('geese_trunk') != line['inferences'] or any(
                n for name, n in k.items() if name != 'geese_trunk'):
            fail('the exported program launched %s in %d inferences'
                 % (k, line['inferences']))
        line['op'] = op_checks(torch, GeeseNet)
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_device_branches(torch, repo, GeeseNet, make_env, ckpt, learner,
                          fused):
    """Phase 11: (a)-(d) and the rates beside phases 5 and 6."""
    log('== phase 11(a)-(c), at once: the split path (DeviceGenerator, host '
        'trainer); the threaded replay trainer with device ingest, a '
        'checkpoint opponent on the device evaluator; the threaded replay '
        'trainer with the host push (TicTacToe); and 11(d)\'s export on the '
        'CPU')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_pt2_')
    try:
        pt2 = os.path.join(tmp, 'model.pt2')
        split, replay, host_push, export_s = concurrently(
            lambda: phase_split(torch, repo),
            lambda: phase_replay(torch, repo, ckpt),
            lambda: phase_host_push(torch, repo),
            lambda: export_program(repo, ckpt, pt2))
        log('== phase 11(d): the export round trip (.pt2 with K1 inside)')
        export = phase_export(torch, repo, GeeseNet, make_env, ckpt, pt2,
                              export_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = ('host (5)', 'fused (6)', 'split (11a)', 'replay (11b)')
    lines = (learner, fused['line'], split['line'], replay['line'])
    log('device branches beside the host learner and the fused loop, same '
        'card (%s):' % nvidia_smi_line())
    log('  %-28s %s' % ('', ' '.join('%14s' % n for n in names)))
    for k in ('episodes_per_s', 'trajectories_per_s', 'update_steps_per_s',
              'trainer_batch_wait_seconds', 'trainer_seconds'):
        log('  %-28s %s' % (k, ' '.join(
            '%14.3f' % l[k] if l.get(k) is not None else '%14s' % '-'
            for l in lines)))
    return {'split': split, 'replay': replay, 'host_push': host_push,
            'export': export}


# ------------------------------------ phase 12: the device actor backend

DA_LANES, DA_CHUNK, DA_SLOTS = 64, 16, 2
DA_DEVICE = 'cuda'
DA_GENERATION = {'backend': 'device', 'device_actor_envs': DA_LANES,
                 'device_actor_chunk_steps': DA_CHUNK,
                 'device_actor_slots': DA_SLOTS}
# (c) a local learner whose one gather is a DeviceActorGather
DA_LOCAL = {'batched_generation': False, 'worker': {'num_parallel': 1},
            'generation': DA_GENERATION, 'epochs': 2,
            'minimum_episodes': 128, 'update_episodes': 128,
            'eval_rate': 0.1, 'policy_target': 'VTRACE',
            'value_target': 'VTRACE'}
# (d) tictactoe.json on --server and a worker host of backend 'device'
DA_REMOTE_EPOCHS = 2     # 3 until phase 17 needed the time (PERF.md §4)
PHASE12_TIMEOUT = 150


def da_tasks(block, mids, players, opponents=('random', 'rulebase')):
    """A block of DA_LANES stamped tasks: 40 'g' tasks (self-play of the
    first id and cross pairings of both, alternating) and 24 'e' tasks
    against the first and the last of ``opponents`` (explicit), keys from
    ``block``."""
    a, b = mids
    tasks = []
    for k in range(DA_LANES):
        key = block * 1000 + k
        if k < 40:
            mid = ({p: a for p in range(players)} if k % 2 == 0 else
                   {p: (a if p % 2 == 0 else b) for p in range(players)})
            tasks.append({'role': 'g', 'player': list(range(players)),
                          'model_id': mid, 'sample_key': key,
                          'task_id': key})
        else:
            seat = k % players
            tasks.append({'role': 'e', 'player': [seat],
                          'model_id': {p: ((a if k % 2 else b) if p == seat
                                           else -1)
                                       for p in range(players)},
                          'opponent': opponents[0 if k < 52 else -1],
                          'sample_key': key, 'task_id': key})
    return tasks


def da_vault(torch, make_env, env_args, build, seed):
    """A ModelVault on the card whose snapshots are seeded nets from
    ``build()`` (model id m drawn from seed + m)."""
    from handyrl_tpu_torch.inference import ModelVault
    from handyrl_tpu_torch.model import ModelWrapper
    env = make_env(env_args)
    env.reset()
    snaps = {}

    def fetch(mid):
        if mid not in snaps:
            net = build()
            net.reset_parameters(torch.Generator().manual_seed(seed + mid))
            snaps[mid] = ModelWrapper(net, 'cpu').snapshot()
        return snaps[mid]
    return ModelVault(fetch, env.observation(env.players()[0]),
                      capacity=DA_SLOTS + 2, device=DA_DEVICE)


def da_train_args(env_args, extra=None):
    from handyrl_tpu_torch.config import apply_defaults
    cfg = apply_defaults({'env_args': dict(env_args), 'train_args': dict(
        {'seed': SEED}, **(extra or {}))})
    ta = dict(cfg['train_args'])
    ta['env'] = cfg['env_args']
    return ta


def phase_da_strict(torch, make_env, env_args=TTT_ENV, build=None,
                    label='12(a)', chunk=DA_CHUNK, opponents=('random',)):
    """12(a) (and 13(a) on ConnectX): one block of 64 stamped tasks of a
    turn-based env on the card in strict mode; every episode byte-equal to
    the host Generator's record of the task on the card."""
    from handyrl_tpu_torch.connection import pack
    from handyrl_tpu_torch.device_generation import DeviceActorEngine
    from handyrl_tpu_torch.environment import make_device_env
    from handyrl_tpu_torch.generation import Generator
    from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
    ta = da_train_args(env_args)
    vault = da_vault(torch, make_env, env_args, build or SimpleConv2dModel,
                     SEED + 40)
    eng = DeviceActorEngine(make_device_env(env_args), vault,
                            make_env(env_args), ta, n_envs=DA_LANES,
                            chunk_steps=chunk, slots=DA_SLOTS,
                            seed=SEED, device=DA_DEVICE)
    if eng.record_mode != 'strict':
        fail('%s: the %s engine runs %r records' % (label, env_args['env'],
                                                   eng.record_mode))
    tasks = da_tasks(0, (1, 2), 2, opponents=opponents)
    t0 = time.monotonic()
    uploads, deferred = eng.run_block(tasks)
    block_s = time.monotonic() - t0
    if deferred or len(uploads) != len(tasks) or any(
            p is None for _, p in uploads):
        fail('%s: %d deferred, %d uploads for %d tasks, %d None'
             % (label, len(deferred), len(uploads), len(tasks),
                sum(p is None for _, p in uploads)))
    gen = Generator(make_env(env_args), ta)
    checked = 0
    for task, (kind, payload) in zip(tasks, uploads):
        if kind != 'episode':
            continue
        host = gen.execute(vault.obtain(dict(task['model_id'])), task)
        if pack(payload) != pack(host):
            fail('%s: the episode of task %s is not the host '
                 'Generator\'s record byte for byte' % (label,
                                                       task['task_id']))
        if 'record_version' in payload:
            fail('%s: a strict record carries record_version' % label)
        checked += 1
    st = eng.stats
    out = {'episodes_byte_equal': checked, 'verified': st['episodes'],
           'divergences': st['divergences'], 'results': st['results'],
           'chunks': st['chunks'], 'block_seconds': block_s,
           'fill_ratio': eng.last_block['fill_ratio'],
           'chunk_ms': eng.last_block['chunk_ms']}
    log('%s strict %s: %s' % (label, env_args['env'], json.dumps(out)))
    return out


def phase_da_geese(torch, make_env, GeeseNet):
    """12(b): two blocks of 64 tasks at full width on the card with
    different slot -> model id maps; one graph capture; K1's serving
    launches chunks x chunk_steps x slots; the recorded probabilities and
    values held to the slot's model on the recorded boards."""
    import numpy as np
    from handyrl_tpu_torch.device_generation import DeviceActorEngine
    from handyrl_tpu_torch.environment import make_device_env
    from handyrl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from handyrl_tpu_torch.ops.batch import decompress_moments
    ta = da_train_args(GEESE_ENV, {
        'turn_based_training': False, 'observation': True, 'gamma': 0.99,
        'eval': {'opponent': ['random', 'rulebase']}})
    vault = da_vault(torch, make_env, GEESE_ENV,
                     lambda: GeeseNet(torus_impl='pallas'), SEED + 50)
    eng = DeviceActorEngine(make_device_env(GEESE_ENV), vault,
                            make_env(GEESE_ENV), ta, n_envs=DA_LANES,
                            chunk_steps=DA_CHUNK, slots=DA_SLOTS,
                            seed=SEED, device=DA_DEVICE)
    if eng.record_mode != 'device':
        fail('12(b): the Geese engine runs %r records' % eng.record_mode)
    for mid in (1, 2, 3, 4):
        vault.model(mid)       # materialized before the counts (no forward)
    blocks = []
    reset_kernel_launches()
    for block, mids in ((1, (1, 2)), (2, (3, 4))):
        tasks = da_tasks(block, mids, 4)
        uploads, deferred = eng.run_block(tasks)
        if deferred or len(uploads) != DA_LANES:
            fail('12(b): block %d deferred %d tasks, %d uploads'
                 % (block, len(deferred), len(uploads)))
        blocks.append((tasks, uploads, dict(eng.last_block)))
    launches = kernel_launches()
    st = eng.stats
    want = st['chunks'] * DA_CHUNK * DA_SLOTS
    if launches['geese_trunk'] != want or any(
            n for k, n in launches.items() if k != 'geese_trunk'):
        fail('12(b): kernel launches %s; K1 expected %d (%d chunks x %d '
             'plies x %d slots)' % (launches, want, st['chunks'], DA_CHUNK,
                                    DA_SLOTS))
    if eng.captures != 1 or eng.builds != 1:
        fail('12(b): %d graph captures and %d builds over two slot maps'
             % (eng.captures, eng.builds))
    if st['none_payloads']:
        fail('12(b): %d lanes uploaded None' % st['none_payloads'])
    for tasks, uploads, _ in blocks:
        for task, (kind, payload) in zip(tasks, uploads):
            if kind == 'episode' and payload.get('record_version') != 1:
                fail('12(b): an episode without record_version 1')
            if kind == 'result' and payload['opponent'] != task['opponent']:
                fail('12(b): a result against %r for a task against %r'
                     % (payload['opponent'], task['opponent']))
    # the network oracle: the slot's model on the recorded boards gives
    # the recorded probability and value
    err = 0.0
    tasks, uploads, _ = blocks[1]
    for task, (kind, payload) in list(zip(tasks, uploads))[:4]:
        if kind != 'episode':
            continue
        model = vault.model(task['model_id'][0])
        for moment in decompress_moments(payload['moment']):
            seats = [p for p in moment['turn']
                     if task['model_id'][p] == task['model_id'][0]]
            if not seats:
                continue
            out = model.batch_inference(np.stack(
                [moment['observation'][p] for p in seats]))
            logits = out['policy']
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            for row, p in enumerate(seats):
                err = max(err, abs(float(probs[row, moment['action'][p]])
                                   - moment['selected_prob'][p]),
                          float(np.abs(out['value'][row]
                                       - moment['value'][p]).max()))
    if not err <= POLICY_TOL:
        fail('12(b): recorded prob/value off the slot model by %.3g' % err)
    chunk_ms = blocks[1][2]['chunk_ms']
    out = {'launches': launches, 'chunks': st['chunks'],
           'graph_captures': eng.captures, 'episodes': st['episodes'],
           'results': st['results'], 'plies': st['plies'],
           'fill_ratio': st['plies'] / st['scheduled_plies'],
           'block_seconds': [b[2]['seconds'] for b in blocks],
           'block_chunks': [b[2]['chunks'] for b in blocks],
           'chunk_ms_replay_median': float(np.median(chunk_ms)),
           'chunk_ms_replay_mean': float(np.mean(chunk_ms)),
           'first_block_chunk_ms': blocks[0][2]['chunk_ms'][:3],
           'oracle_max_abs_err': err,
           'plies_per_s': st['plies'] / sum(b[2]['seconds']
                                            for b in blocks)}
    log('12(b) Geese device records, full width (%s): %s'
        % (nvidia_smi_line(), json.dumps(out)))
    return out


def da_check_line(label, line, epochs, train_kernels):
    """A device-actor learner's JSON line: its epochs, finite losses, the
    training kernels once a step and nothing else in the learner, every
    episode counted once, an empty ledger, and one gather's device actor
    counts: no None payload, one chunk program, the stamped episodes the
    engine's (device records), K1 in the gather when the env runs it."""
    import math
    from handyrl_tpu_torch.ops.train_step import GRAPH_WARMUP_STEPS
    if line['epochs'] != epochs or line['failed'] or line['fleet_failure']:
        fail('%s trained %s epochs (failed %s %s %s)' % (
            label, line['epochs'], line['failed'], line['failed_reason'],
            line['fleet_failure']))
    if not (line['losses'] and all(math.isfinite(v)
                                   for v in line['losses'].values())):
        fail('%s reports non-finite losses: %s' % (label, line['losses']))
    by_path = line['kernel_launches']
    runs = line['steps_at_exit'] + GRAPH_WARMUP_STEPS
    train = by_path.get('training', {})
    if set(by_path) - {'training'} or any(
            train.get(k, 0) != (runs if k in train_kernels else 0)
            for k in train):
        fail('%s launched %s in the learner (%s once a step of %d expected)'
             % (label, by_path, train_kernels, runs))
    if line['fleet']['outstanding'] != 0 or line['repeated_sample_keys'] \
            or line['distinct_sample_keys'] != line['episodes']:
        fail('%s: outstanding %d, repeated keys %d, %d distinct keys for %d '
             'episodes' % (label, line['fleet']['outstanding'],
                           line['repeated_sample_keys'],
                           line['distinct_sample_keys'], line['episodes']))
    if len(line['device_actor']) != 1:
        fail('%s: %d device actor beacons' % (label,
                                               len(line['device_actor'])))
    actor = line['device_actor'][0]
    if actor['none_payloads'] or actor['host_failures'] \
            or actor['builds'] != 1 or actor['graph_captures'] != 1 \
            or not actor['device'].startswith(DA_DEVICE):
        fail('%s: device actor %s' % (label, actor))
    stamped = actor['episodes'] if actor['record_mode'] == 'device' else 0
    if line['stamped_episodes'] != stamped or not actor['episodes'] > 0:
        fail('%s: %d stamped episodes, the engine spliced %d (%s records)'
             % (label, line['stamped_episodes'], actor['episodes'],
                actor['record_mode']))
    return actor


def phase_da_local(torch, repo):
    """12(c): the local learner on phase 5's config with one
    DeviceActorGather, VTRACE/VTRACE, through the entry point (no
    --device)."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_da_local_')
    try:
        path = worker_plane_config(tmp, DA_LOCAL)
        t0 = time.monotonic()
        try:
            proc = subprocess.run(
                [sys.executable, '-m', 'handyrl_tpu_torch.train',
                 '--config', path], cwd=repo, capture_output=True,
                text=True, timeout=PHASE12_TIMEOUT)
        except subprocess.TimeoutExpired as exc:
            fail('12(c) did not finish within %d s:\n%s' % (
                PHASE12_TIMEOUT, (exc.stderr or b'')[-4000:]))
        wall = time.monotonic() - t0
        for l in proc.stdout.splitlines():
            if l.startswith(('epoch', 'win rate', 'loss', 'updated model')):
                log('  12(c): %s' % l)
        if proc.returncode != 0:
            fail('12(c) exited %d:\n%s' % (proc.returncode,
                                           proc.stderr[-4000:]))
        line = learner_json('12(c)', proc.stdout)
        line['wall'] = wall
        actor = da_check_line('12(c)', line, DA_LOCAL['epochs'],
                              ('geese_trunk', 'geese_trunk_bwd', 'vtrace'))
        k1 = actor['launches'].get('geese_trunk', 0)
        if not k1 >= actor['chunks'] * DA_CHUNK * DA_SLOTS:
            fail('12(c): K1 launched %d times in the gather for %d chunks'
                 % (k1, actor['chunks']))
        left = processes_left(proc.stderr)
        if left:
            fail('12(c): gather processes left after the run: %s' % left)
        out = {'episodes': line['episodes'],
               'episodes_per_s': line['episodes_per_s'],
               'trajectories_per_s': line['trajectories_per_s'],
               'trainer_wait_share': (line['trainer_batch_wait_seconds']
                                      / line['trainer_seconds']
                                      if line['trainer_seconds'] else None),
               'stamped_episodes': line['stamped_episodes'],
               'device_episodes': actor['episodes'],
               'results': actor['results'], 'deferred': actor['deferred'],
               'gather_k1_launches': k1, 'chunks': actor['chunks'],
               'fill_ratio': actor['fill_ratio'],
               'chunk_seconds': actor['chunk_seconds'],
               'block_seconds': actor['block_seconds'],
               'none_payloads': actor['none_payloads'], 'wall': wall,
               'kernel_launches': line['kernel_launches'],
               'gather_launches': actor['launches']}
        log('12(c) local learner, one DeviceActorGather (%s): %s'
            % (nvidia_smi_line(), json.dumps(out)))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_da_remote(torch, repo):
    """12(d): tictactoe.json on ``--server`` and a worker host whose
    ``worker_args.backend`` is 'device', over localhost TCP on free
    ports, DA_REMOTE_EPOCHS epochs."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_da_remote_')
    procs = {}
    try:
        cfg = quick_config(repo, {'model_dir': os.path.join(tmp, 'models')},
                           DA_REMOTE_EPOCHS)
        cfg['worker_args'] = {'server_address': '127.0.0.1',
                              'num_parallel': 1, 'backend': 'device'}
        path = os.path.join(tmp, 'config.json')
        with open(path, 'w') as f:
            json.dump(cfg, f)
        entry, data = free_ports(2)
        env = dict(os.environ, HANDYRL_TPU_ENTRY_PORT=str(entry),
                   HANDYRL_TPU_DATA_PORT=str(data))
        logs = {k: (os.path.join(tmp, k + '.out'),
                    os.path.join(tmp, k + '.err'))
                for k in ('server', 'host')}
        cmds = {'server': ['handyrl_tpu_torch.train', '--config', path,
                           '--server'],
                'host': ['handyrl_tpu_torch.worker', '--config', path]}
        t0 = time.monotonic()
        for k in ('server', 'host'):
            with open(logs[k][0], 'w') as out, open(logs[k][1], 'w') as err:
                procs[k] = subprocess.Popen(
                    [sys.executable, '-m'] + cmds[k], cwd=repo, stdout=out,
                    stderr=err, start_new_session=True, env=env)
        deadline = time.monotonic() + PHASE12_TIMEOUT
        for k in ('host', 'server'):
            try:
                procs[k].wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail('12(d) did not finish within %d s; the server:\n%s\n%s'
                     '\nthe worker host:\n%s\n%s' % (
                         PHASE12_TIMEOUT, tail(logs['server'][0], 20),
                         tail(logs['server'][1]), tail(logs['host'][0]),
                         tail(logs['host'][1])))
        wall = time.monotonic() - t0
        for k in ('server', 'host'):
            if procs[k].returncode != 0:
                fail('12(d): the %s exited %d:\n%s' % (
                    k, procs[k].returncode, tail(logs[k][1])))
        with open(logs['server'][0]) as f:
            line = learner_json('12(d)', f.read())
        with open(logs['host'][1]) as f:
            host_err = f.read()
        if 'device actor backend on %s' % DA_DEVICE not in host_err:
            fail('12(d): the worker host\'s gather did not run the device '
                 'actor backend:\n%s' % host_err[-2000:])
        actor = da_check_line('12(d)', line, DA_REMOTE_EPOCHS,
                              ('td_lambda',))
        left = processes_left(host_err)
        if left:
            fail('12(d): gather processes left after the run: %s' % left)
        out = {'episodes': line['episodes'],
               'episodes_per_s': line['episodes_per_s'],
               'record_mode': actor['record_mode'],
               'device_episodes': actor['episodes'],
               'divergences': actor['divergences'],
               'results': actor['results'], 'deferred': actor['deferred'],
               'chunks': actor['chunks'], 'fill_ratio': actor['fill_ratio'],
               'wall': wall, 'kernel_launches': line['kernel_launches'],
               'gather_launches': actor['launches']}
        log('12(d) TicTacToe over TCP, worker_args.backend device (%s): %s'
            % (nvidia_smi_line(), json.dumps(out)))
        return out
    finally:
        for proc in procs.values():
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except OSError:
                pass
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_device_actor(torch, repo, GeeseNet, make_env):
    """Phase 12: (a)-(d), one JSON line."""
    t0 = time.monotonic()
    log('== phase 12(a): the device actor engine, TicTacToe, strict '
        'records')
    strict = phase_da_strict(torch, make_env)
    log('== phase 12(b): the device actor engine, Hungry Geese at full '
        'width, device records')
    geese = phase_da_geese(torch, make_env, GeeseNet)
    # the engines of (a) and (b) ran in this process and marked its
    # steady state (process-global, as in a gather): the later phases'
    # in-process captures are no gather's retraces
    from handyrl_tpu_torch import telemetry
    telemetry.clear_steady_state()
    log('== phase 12(c), (d), at once: a local learner with one '
        'DeviceActorGather; --server and a worker host with '
        'worker_args.backend device (TicTacToe)')
    local, remote = concurrently(lambda: phase_da_local(torch, repo),
                                 lambda: phase_da_remote(torch, repo))
    out = {'phase': 12, 'strict': strict, 'geese': geese, 'local': local,
           'remote': remote, 'seconds': time.monotonic() - t0,
           'card': nvidia_smi_line()}
    print(json.dumps(out), flush=True)
    return out


# ------------------------------- phase 13: ConnectX and the GeeseNetLSTM

PHASE13_TIMEOUT = 300     # each learner process
CX_ENV = {'env': 'ConnectX'}
CX_EPOCHS = 2            # the fused loop's; 3 until phase 17 (PERF.md §4)
CX_HOST_EPOCHS = 1       # the host learner's; 3 until phase 17
CX_GAMES, CX_PROCS = 16, 4   # 100 games until phase 17
CX_BOARDS = 1000
LSTM_ENV = {'env': 'HungryGeese', 'net_kind': 'lstm'}
LSTM_BURN_IN = 4
LSTM_EPOCHS = 1          # 2 until phase 16 needed the time (PERF.md §4)
LSTM_TARGETS = (16, 4, 512)    # (T, P, lanes) of the LSTM host step's K5
# the timed recurrent step: the fused loop's batch (B=64, T=16 + burn-in,
# the solo layout's one row a window)
LSTM_STEP_B = 64
LSTM_STEP_REPS = 20
LSTM_SERVE_PLIES = 6
LSTM_EVAL_GAMES = 64
# phase 5's config on the recurrent net, its episodes cut to fit the
# phase (64 + 64, 64 + 128 until phase 17: the recurrent host learner
# plays ~10 episodes/s)
LSTM_LEARNER = {
    'env_args': dict(LSTM_ENV),
    'train_args': dict(LEARNER_CONFIG['train_args'], **{
        'policy_target': 'VTRACE', 'value_target': 'VTRACE',
        'burn_in_steps': LSTM_BURN_IN, 'epochs': LSTM_EPOCHS,
        'minimum_episodes': 64, 'update_episodes': 64}),
}
# phase 6's north-star config on the recurrent net, 3 epochs: the fused
# loop's metrics arrive a dispatch late (the second epoch's close reads
# the warm-up dispatch's, none)
LSTM_FUSED_EPOCHS = 3
LSTM_FUSED = {
    'env_args': dict(LSTM_ENV),
    'train_args': dict(FUSED_CONFIG['train_args'], **{
        'burn_in_steps': LSTM_BURN_IN, 'epochs': LSTM_FUSED_EPOCHS,
        'checkpoint_interval': LSTM_FUSED_EPOCHS}),
}


def check_learner_line(label, line, epochs, want):
    """A phase-13 learner's JSON line: its epochs with finite losses and
    no failed trainer; each kernel of ``want`` ({launch path: kernels})
    launched and nothing else anywhere."""
    import math
    if line['failed'] or line['epochs'] != epochs:
        fail('%s trained %s epochs (failed: %s)' % (
            label, line['epochs'], line['failed_reason']))
    if not (line['losses'] and all(math.isfinite(v)
                                   for v in line['losses'].values())):
        fail('%s reports non-finite losses: %s' % (label, line['losses']))
    by_path = line['kernel_launches']
    for where, kernels in want.items():
        for k in kernels:
            if not by_path.get(where, {}).get(k, 0) > 0:
                fail('%s: %s never launched %s (%s)' % (label, where, k,
                                                         by_path))
    wanted = {(w, k) for w, ks in want.items() for k in ks}
    extra = {(w, k): n for w, c in by_path.items() for k, n in c.items()
             if n and (w, k) not in wanted}
    if extra:
        fail('%s launched kernels off its path: %s' % (label, extra))
    trainer_s = line['trainer_seconds'] or 0.0
    out = {'episodes': line['episodes'],
           'episodes_per_s': line['episodes_per_s'],
           'update_steps_per_s': line['update_steps_per_s'],
           'trajectories_per_s': line['trajectories_per_s'],
           'trainer_wait_share': (line['trainer_batch_wait_seconds']
                                  / trainer_s if trainer_s else None),
           'peak_memory_mib': line['peak_memory_mib'],
           'kernel_launches': by_path, 'wall': line['wall']}
    log('%s: %s (%s)' % (label, json.dumps(out), nvidia_smi_line()))
    return out


def cx_greedy_boards(torch, make_env):
    """13(a): the twin's ``greedy_action`` on CX_BOARDS positions on the
    card against the host env's ``rule_based_action`` on each (positions
    from seeded play, half of it the heuristic's, so wins and blocks come
    up)."""
    import random
    from handyrl_tpu_torch.envs import torch_connectx as tc
    rng = random.Random(SEED + 13)
    boards, sides, moves, want = [], [], [], []
    env = make_env(CX_ENV)
    env.reset()
    while len(boards) < CX_BOARDS:
        if env.terminal():
            env.reset()
            continue
        boards.append(env.cells.copy())
        sides.append(env.side)
        moves.append(len(env.moves))
        want.append(env.rule_based_action(env.turn()))
        env.play(env.rule_based_action(env.turn()) if rng.random() < 0.5
                 else rng.choice(env.legal_actions()))
    import numpy as np
    dev = torch.device('cuda')
    state = tc.State(
        boards=torch.from_numpy(np.stack(boards)).to(dev),
        side=torch.tensor(sides, dtype=torch.int8, device=dev),
        winner=torch.zeros(len(boards), dtype=torch.int8, device=dev),
        moves=torch.tensor(moves, dtype=torch.int8, device=dev))
    got = tc.greedy_action(state).cpu().numpy()
    bad = int((got != np.asarray(want)).sum())
    if bad:
        fail('13(a): greedy_action on the card disagrees with '
             'rule_based_action on %d of %d boards' % (bad, len(boards)))
    return {'boards': len(boards), 'disagree': bad}


def phase_connectx(torch, repo, make_env):
    """13(a): ConnectX on the host learner and the fused 'turn' loop at
    once (tictactoe.json's train_args, CX_HOST_EPOCHS and CX_EPOCHS
    epochs), a strict device
    actor block, the twin's heuristic against the host's, and a
    tournament of the host learner's checkpoint against 'rulebase'."""
    from handyrl_tpu_torch.models.connect_four import ConnectFourNet
    tmp = tempfile.mkdtemp(prefix='chip_smoke_connectx_')
    try:
        cfg = quick_config(repo, None, CX_HOST_EPOCHS)
        cfg['env_args'] = dict(CX_ENV)
        host_tmp = os.path.join(tmp, 'host')
        os.makedirs(host_tmp)
        fcfg = quick_config(repo, QUICK_FUSED, CX_EPOCHS)
        fcfg['env_args'] = dict(CX_ENV)
        fused_tmp = os.path.join(tmp, 'fused')
        os.makedirs(fused_tmp)
        # the two learners at once (each a process of its own)
        (line, _), (fline, stdout) = concurrently(
            lambda: run_train_cli(repo, cfg, host_tmp, '13(a) host learner',
                                  timeout=PHASE13_TIMEOUT),
            lambda: run_train_cli(repo, fcfg, fused_tmp, '13(a) fused loop',
                                  timeout=PHASE13_TIMEOUT))
        host = check_learner_line('13(a) ConnectX host learner', line,
                                  CX_HOST_EPOCHS,
                                  {'training': ('td_lambda',)})
        if not fline.get('fused') or '(turn mode)' not in stdout:
            fail('13(a): ConnectX did not run the fused loop in turn mode')
        fused = check_learner_line('13(a) ConnectX fused loop (turn mode)',
                                   fline, CX_EPOCHS,
                                   {'training': ('td_lambda',)})
        fused['windows_ingested'] = fline['windows_ingested']
        strict = phase_da_strict(torch, make_env, CX_ENV, ConnectFourNet,
                                 '13(a)', opponents=('random', 'rulebase'))
        greedy = cx_greedy_boards(torch, make_env)
        log('13(a) greedy_action vs rule_based_action: %s'
            % json.dumps(greedy))
        # the tournament: the host learner's last checkpoint against the
        # heuristic, in spawned processes on the card
        config = os.path.join(tmp, 'connectx.json')
        with open(config, 'w') as f:
            json.dump({'env_args': dict(CX_ENV)}, f)
        ckpt = os.path.join(host_tmp, 'models', 'latest.ckpt')
        t0 = time.monotonic()
        try:
            proc = subprocess.run(
                [sys.executable, '-m', 'handyrl_tpu_torch.evaluation',
                 ckpt + ':rulebase', str(CX_GAMES), str(CX_PROCS),
                 '--config', config], cwd=repo, capture_output=True,
                text=True, timeout=PHASE13_TIMEOUT)
        except subprocess.TimeoutExpired as exc:
            fail('13(a): the tournament did not finish within %d s:\n%s'
                 % (PHASE13_TIMEOUT, (exc.stderr or b'')[-4000:]))
        if proc.returncode != 0:
            fail('13(a): the tournament exited %d:\n%s'
                 % (proc.returncode, proc.stderr[-4000:]))
        agents, report = parse_report(proc.stdout, CX_GAMES, CX_PROCS,
                                      '13(a) the tournament')
        for l in report:
            log('  13(a) tournament: %s' % l)
        tally, win_rate = agents[0]['total']
        if sum(tally.values()) != CX_GAMES:
            fail('13(a): the tournament counted %s for %d games'
                 % (tally, CX_GAMES))
        tournament = {'games': CX_GAMES, 'win_rate_vs_rulebase': win_rate,
                      'tally': {str(k): v for k, v in tally.items()},
                      'wall': time.monotonic() - t0}
        out = {'host': host, 'fused': fused, 'strict': strict,
               'greedy': greedy, 'tournament': tournament}
        log('13(a) ConnectX (%s): %s' % (nvidia_smi_line(), json.dumps(
            {k: v for k, v in out.items() if k != 'strict'})))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def lstm_net(torch, seed):
    from handyrl_tpu_torch.models.geese import GeeseNetLSTM
    return GeeseNetLSTM(generator=torch.Generator().manual_seed(seed))


def lstm_serving(torch, repo, make_env):
    """13(b): ``python -m handyrl_tpu_torch.serving`` on a full-width
    GeeseNetLSTM: four geese a ply over LSTM_SERVE_PLIES plies, each
    request carrying its goose's state from the previous reply; every
    served policy, value and next state against a local CPU forward of the
    same weights and the same state chain."""
    import numpy as np
    from handyrl_tpu_torch.model import ModelWrapper
    from handyrl_tpu_torch.serving.client import ServiceClient
    from handyrl_tpu_torch.serving.registry import ModelRegistry
    net = lstm_net(torch, SEED + 60)
    local = ModelWrapper(net, device='cpu')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_lstm_serve_')
    proc, client = None, None
    try:
        root = os.path.join(tmp, 'registry')
        ModelRegistry(root).publish('default', snapshot=local.snapshot(),
                                    version=1, promote=True)
        err_path = os.path.join(tmp, 'service.err')
        with open(err_path, 'wb') as err:
            proc = subprocess.Popen(
                [sys.executable, '-m', 'handyrl_tpu_torch.serving', '--env',
                 'HungryGeese', '--registry', root, '--port', '0'],
                cwd=repo, stdout=subprocess.PIPE, stderr=err)
        ready = read_ready_line(proc, timeout=300)
        if ready['device'] != 'cuda':
            fail('13(b): the service runs on %r' % ready['device'])
        client = ServiceClient('localhost', ready['port'], timeout=120,
                               name='chip_smoke_lstm')
        env = make_env({'env': 'HungryGeese', 'id': SEED + 61})
        env.reset()
        served = {p: None for p in env.players()}
        mine = {p: local.init_hidden() for p in env.players()}
        err, ms = 0.0, []
        for ply in range(LSTM_SERVE_PLIES):
            if env.terminal():
                break
            t0 = time.perf_counter()
            rids = {p: client.submit('default@champion', env.observation(p),
                                     hidden=served[p]) for p in env.turns()}
            replies = {p: client.collect(r, timeout=120)['outputs']
                       for p, r in rids.items()}
            ms.append(1e3 * (time.perf_counter() - t0))
            actions = {}
            for p, out in replies.items():
                want = local.inference(env.observation(p), mine[p])
                if len(out['hidden']) != 2 or out['hidden'][0].shape != (
                        7, 11, net.filters):
                    fail('13(b): the reply\'s hidden state is %s'
                         % [np.shape(h) for h in out['hidden']])
                for a, b in ([(out['policy'], want['policy']),
                              (out['value'], want['value'])]
                             + list(zip(out['hidden'], want['hidden']))):
                    err = max(err, float(np.abs(np.asarray(a)
                                                - np.asarray(b)).max()))
                served[p], mine[p] = out['hidden'], want['hidden']
                actions[p] = int(np.argmax(out['policy']))
            env.step(actions)
        status = client.status()
        if not err <= POLICY_TOL:
            fail('13(b): the served outputs and state are off the CPU '
                 'forward by %.3g' % err)
        if status['answered'] != status['received']:
            fail('13(b): unanswered requests: %s' % status)
        client.close()
        client = None
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 75:
            fail('13(b): the service exited %d after SIGTERM' % rc)
        out = {'plies': len(ms), 'max_abs_err': err,
               'ply_ms': ms, 'requests': status['received'],
               'launches': status['kernel_launches']}
        log('13(b) served GeeseNetLSTM with hidden state (%s): %s'
            % (nvidia_smi_line(), json.dumps(out)))
        return out
    finally:
        if client is not None:
            client.close()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


def lstm_step_ms(torch):
    """13(b): one recurrent update step at full width as a CUDA graph
    (GraphedUpdateStep) on a batch of the fused loop's shape (B=64,
    T=16 + LSTM_BURN_IN, P=1, VTRACE/VTRACE), CUDA events over
    LSTM_STEP_REPS replays; its metrics finite and the step not
    flagged."""
    import numpy as np
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.ops.train_step import (build_graphed_update_step,
                                                  init_train_state)
    B, T = LSTM_STEP_B, 16 + LSTM_BURN_IN
    rng = np.random.RandomState(SEED + 62)
    net = lstm_net(torch, SEED + 63).cuda()
    ones = np.ones((B, T, 1, 1), np.float32)
    batch = {
        'observation': (rng.rand(B, T, 1, 17, 7, 11) < 0.15).astype(
            np.float32),
        'selected_prob': rng.uniform(0.1, 1, (B, T, 1, 1)).astype(
            np.float32),
        'value': rng.uniform(-1, 1, (B, T, 1, 1)).astype(np.float32),
        'action': rng.randint(0, 4, (B, T, 1, 1)).astype(np.int32),
        'outcome': np.sign(rng.randn(B, 1, 1, 1)).astype(np.float32),
        'reward': np.zeros((B, T, 1, 1), np.float32),
        'return': np.zeros((B, T, 1, 1), np.float32),
        'episode_mask': ones, 'turn_mask': ones, 'observation_mask': ones,
        'action_mask': np.zeros((B, T, 1, 4), np.float32),
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0)}
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in batch.items()}
    cfg = LossConfig(turn_based_training=False, observation=True,
                     burn_in_steps=LSTM_BURN_IN, policy_target='VTRACE',
                     value_target='VTRACE', gamma=0.99)
    step = build_graphed_update_step(net, cfg, init_train_state(net))
    lr = torch.tensor(1e-5, device='cuda')
    metrics = step(batch, lr)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LSTM_STEP_REPS):
        metrics = step(batch, lr)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / LSTM_STEP_REPS
    vals = {k: float(v) for k, v in metrics.items()}
    if vals['nonfinite'] or not all(np.isfinite(list(vals.values()))):
        fail('13(b): the recurrent step\'s metrics: %s' % vals)
    return {'ms': ms, 'B': B, 'T': T, 'reps': LSTM_STEP_REPS,
            'total': vals['total']}


def lstm_device_eval(torch, ckpt):
    """13(b): the device evaluator with a full-width GeeseNetLSTM against
    'random' and a recurrent checkpoint opponent (the host learner's last
    checkpoint), LSTM_EVAL_GAMES matches on the card."""
    import numpy as np
    from handyrl_tpu_torch.device_generation import DeviceEvaluator
    from handyrl_tpu_torch.envs import torch_hungry_geese as tg
    net = lstm_net(torch, SEED + 64).cuda().eval()
    ev = DeviceEvaluator(tg, net, {}, n_envs=32, chunk_steps=32,
                         seed=SEED, opponents=['random', ckpt])
    if not ev.recurrent or ev.opp_hidden is None:
        fail('13(b): the device evaluator did not carry recurrent state')
    t0 = time.monotonic()
    results = ev.play(LSTM_EVAL_GAMES)
    results += ev.drain()
    seconds = time.monotonic() - t0
    by_opp = {}
    for r in results:
        seat = r['args']['player'][0]
        by_opp.setdefault(r['opponent'], []).append(r['result'][seat])
        if abs(sum(r['result'].values())) > 1e-5:
            fail('13(b): a result that is not zero-sum: %s' % r)
    if set(by_opp) != {'random', ckpt}:
        fail('13(b): the evaluator played %s' % sorted(by_opp))
    graphs = int(getattr(ev._call, 'graph', None) is not None)
    if not graphs:
        fail('13(b): the recurrent evaluator\'s chunk was never captured')
    for h in ev.hidden + ev.opp_hidden:
        if not bool(torch.isfinite(h).all()):
            fail('13(b): non-finite recurrent state in the evaluator')
    out = {'games': len(results), 'dispatches': ev.dispatches,
           'rollout_graphs': graphs, 'seconds': seconds,
           'mean_by_opponent': {('checkpoint' if k == ckpt else k):
                                float(np.mean(v))
                                for k, v in by_opp.items()}}
    log('13(b) device evaluator, recurrent checkpoint opponent: %s'
        % json.dumps(out))
    return out


def lstm_device_actor(torch, make_env):
    """13(b): one block of 64 Geese tasks on recurrent lanes on the card
    ('device' records, as the JAX package plays a recurrent net); each
    goose's recorded probability and value held to its slot's model run
    over its own observations with its state carried (the first four
    episodes)."""
    import numpy as np
    from handyrl_tpu_torch.device_generation import DeviceActorEngine
    from handyrl_tpu_torch.environment import make_device_env
    from handyrl_tpu_torch.models.geese import GeeseNetLSTM
    from handyrl_tpu_torch.ops.batch import decompress_moments
    ta = da_train_args(LSTM_ENV, {
        'turn_based_training': False, 'observation': True, 'gamma': 0.99,
        'burn_in_steps': LSTM_BURN_IN,
        'eval': {'opponent': ['random', 'rulebase']}})
    vault = da_vault(torch, make_env, LSTM_ENV, GeeseNetLSTM, SEED + 70)
    eng = DeviceActorEngine(make_device_env(LSTM_ENV), vault,
                            make_env(LSTM_ENV), ta, n_envs=DA_LANES,
                            chunk_steps=DA_CHUNK, slots=DA_SLOTS,
                            seed=SEED, device=DA_DEVICE)
    if not eng.recurrent or eng.record_mode != 'device':
        fail('13(b): the recurrent engine runs %r records (recurrent %s)'
             % (eng.record_mode, eng.recurrent))
    tasks = da_tasks(3, (1, 2), 4)
    t0 = time.monotonic()
    uploads, deferred = eng.run_block(tasks)
    block_s = time.monotonic() - t0
    if deferred or len(uploads) != DA_LANES or any(
            p is None for _, p in uploads):
        fail('13(b): the recurrent block deferred %d tasks, %d uploads'
             % (len(deferred), len(uploads)))
    err, checked = 0.0, 0
    for task, (kind, payload) in zip(tasks, uploads):
        if kind != 'episode':
            continue
        if payload.get('record_version') != 1:
            fail('13(b): a recurrent episode without record_version 1')
        if checked >= 4:
            continue
        checked += 1
        moments = decompress_moments(payload['moment'])
        for p in range(4):
            model = vault.model(task['model_id'][p])
            hidden = model.init_hidden()
            for moment in moments:
                if p not in moment['turn']:
                    break
                out = model.inference(moment['observation'][p], hidden)
                hidden = out['hidden']
                logits = out['policy']
                probs = np.exp(logits - logits.max())
                probs /= probs.sum()
                err = max(err, abs(float(probs[moment['action'][p]])
                                   - moment['selected_prob'][p]),
                          float(np.abs(out['value']
                                       - moment['value'][p]).max()))
    if not err <= POLICY_TOL:
        fail('13(b): recorded prob/value off the slot model\'s carried '
             'state by %.3g' % err)
    st = eng.stats
    out = {'episodes': st['episodes'], 'results': st['results'],
           'chunks': st['chunks'], 'graph_captures': eng.captures,
           'block_seconds': block_s, 'fill_ratio': eng.last_block[
               'fill_ratio'], 'oracle_max_abs_err': err,
           'chunk_ms': eng.last_block['chunk_ms'][:4]}
    log('13(b) device actor, recurrent lanes: %s' % json.dumps(out))
    return out


def phase_lstm(torch, repo, make_env):
    """13(b): the full-width GeeseNetLSTM served with its state, trained on
    the host learner and the fused loop with burn-in, on the device
    evaluator against a recurrent checkpoint and on the device actor;
    one recurrent update step timed."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_lstm_')
    try:
        serving = lstm_serving(torch, repo, make_env)
        host_tmp = os.path.join(tmp, 'host')
        os.makedirs(host_tmp)
        fused_tmp = os.path.join(tmp, 'fused')
        os.makedirs(fused_tmp)
        # the two learners at once (each a process of its own)
        (line, _), (fline, stdout) = concurrently(
            lambda: run_train_cli(repo, LSTM_LEARNER, host_tmp,
                                  '13(b) host learner',
                                  timeout=PHASE13_TIMEOUT),
            lambda: run_train_cli(repo, LSTM_FUSED, fused_tmp,
                                  '13(b) fused loop',
                                  timeout=PHASE13_TIMEOUT))
        host = check_learner_line('13(b) GeeseNetLSTM host learner', line,
                                  LSTM_EPOCHS, {'training': ('vtrace',)})
        if not fline.get('fused') or '(solo mode)' not in stdout:
            fail('13(b): the GeeseNetLSTM did not run the fused loop')
        fused = check_learner_line('13(b) GeeseNetLSTM fused loop', fline,
                                   LSTM_FUSED_EPOCHS,
                                   {'training': ('vtrace',)})
        fused['dispatch_seconds'] = fline.get('dispatch_seconds')
        torch.cuda.reset_peak_memory_stats()
        step = lstm_step_ms(torch)
        log('13(b) recurrent update step, graphed: %s' % json.dumps(step))
        evaluator = lstm_device_eval(
            torch, os.path.join(host_tmp, 'models', 'latest.ckpt'))
        actor = lstm_device_actor(torch, make_env)
        out = {'serving': serving, 'host': host, 'fused': fused,
               'step': step, 'evaluator': evaluator, 'actor': actor,
               'in_process_peak_memory_mib':
                   torch.cuda.max_memory_allocated() / 2 ** 20}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_connectx_lstm(torch, repo, make_env):
    """Phase 13: (a) and (b), one JSON line."""
    from handyrl_tpu_torch.model import fp32_on_card
    fp32_on_card(torch.device('cuda'))
    t0 = time.monotonic()
    log('== phase 13(a): ConnectX on the host learner, the fused turn '
        'loop, the device actor and the tournament')
    cx = phase_connectx(torch, repo, make_env)
    t_a = time.monotonic() - t0
    log('== phase 13(b): the GeeseNetLSTM served, trained with burn-in on '
        'the host learner and the fused loop, evaluated and played on the '
        'device')
    lstm = phase_lstm(torch, repo, make_env)
    out = {'phase': 13, 'connectx': cx, 'lstm': lstm,
           'seconds_a': t_a, 'seconds': time.monotonic() - t0,
           'card': nvidia_smi_line()}
    print(json.dumps(out), flush=True)
    return out


# ------------------------------------------ phase 14: Geister, BatchNorm

PHASE14_TIMEOUT = 240     # each learner process
GEISTER_ENV = {'env': 'Geister', 'norm_kind': 'batch',
               'policy_head': 'spatial'}
# the JAX package's 'geister' row (scripts/run_benchmark_matrix.py:55-60)
# with norm_kind 'batch' and the spatial head: its shapes (B=32, T=16,
# burn-in 4, 32 envs, observation), its depth cut to one epoch of
# G_UPDATE episodes after G_MINIMUM (the row: 100 after 200). The host
# self-play of Geister is bound by its Python (about 6 episodes/s on an
# H100 host before the trainer starts, 0.3/s beside it, PERF.md), so the
# row's depth would take minutes
G_EPOCHS = 1
G_MINIMUM, G_UPDATE = 32, 4   # 64 after 64 + 8, cut by phases 16, 17
G_TRAIN = {'batch_size': 32, 'forward_steps': 16, 'burn_in_steps': 4,
           'update_episodes': 100, 'minimum_episodes': 200,
           'generation_envs': 32, 'observation': True, 'eval_envs': 32}
G_LEARNER = {'env_args': dict(GEISTER_ENV), 'train_args': dict(
    G_TRAIN, epochs=G_EPOCHS, minimum_episodes=G_MINIMUM,
    update_episodes=G_UPDATE)}
# the 'geister-fused-sp-bn' row (:81-90, :143-147: 32-ply chunks, 4 SGD
# steps a chunk) at the same shapes, its depth cut to G_FUSED_EPOCHS
# epochs of G_FUSED_UPDATE episodes after G_FUSED_MINIMUM (the row: 100
# after 200; 510 episodes took 162 s on an H100)
G_FUSED_EPOCHS = 2
G_FUSED_MINIMUM, G_FUSED_UPDATE = 64, 32
G_FUSED = {'env_args': dict(GEISTER_ENV), 'train_args': dict(
    G_TRAIN, device_generation=True, device_replay=True,
    device_chunk_steps=32, sgd_steps_per_chunk=4, epochs=G_FUSED_EPOCHS,
    minimum_episodes=G_FUSED_MINIMUM, update_episodes=G_FUSED_UPDATE,
    checkpoint_interval=G_FUSED_EPOCHS)}
# the in-process refresh check's pipeline: the full-width net on a few
# lanes (the refresh copies every leaf whatever the lanes)
G_REFRESH = dict(envs=8, chunk=16, batch=8)
G_SERVE_PLIES = 6
G_BATCHED = 8             # requests coalesced against one alone
G_STEP_B = 32             # the recurrent step: B=32, T=16 + burn-in 4
G_STEP_REPS = 10
GEESE_BN_B = 16           # the GeeseNet('batch') VTRACE step, solo, T=16
# a step's running averages on the card against the CPU's: EMAs of fp32
# batch moments summed in other orders, each leaf within 1e-5 of its
# largest element
STATS_RTOL = 1e-5


def geister_net(torch, seed, stats_seed=None):
    """The full-width GeisterNet('batch', 'spatial') with seeded weights
    and, with ``stats_seed``, running averages off their init."""
    from handyrl_tpu_torch.models.geister import GeisterNet
    net = GeisterNet(norm_kind='batch', policy_head='spatial',
                     generator=torch.Generator().manual_seed(seed))
    if stats_seed is not None:
        g = torch.Generator().manual_seed(stats_seed)
        with torch.no_grad():
            for name, b in net.named_buffers():
                noise = torch.rand(b.shape, generator=g)
                b.copy_(0.2 * (noise - 0.5) if name.endswith('mean')
                        else 0.5 + noise)
    return net


def geister_serving(torch, repo, make_env):
    """14(a): ``python -m handyrl_tpu_torch.serving`` on the full-width
    GeisterNet('batch', 'spatial'): both seats for G_SERVE_PLIES plies,
    each request carrying its seat's DRC state from the previous reply,
    every policy, value and next state within POLICY_TOL of a CPU forward
    in inference mode (the running averages); then G_BATCHED requests
    submitted at once (coalesced into one batch) against each sent
    alone."""
    import numpy as np
    from handyrl_tpu_torch.model import ModelWrapper
    from handyrl_tpu_torch.serving.client import ServiceClient
    from handyrl_tpu_torch.serving.registry import ModelRegistry
    net = geister_net(torch, SEED + 140, stats_seed=SEED + 141)
    local = ModelWrapper(net, device='cpu')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_geister_serve_')
    proc, client = None, None
    try:
        root = os.path.join(tmp, 'registry')
        ModelRegistry(root).publish('default', snapshot=local.snapshot(),
                                    version=1, promote=True)
        err_path = os.path.join(tmp, 'service.err')
        with open(err_path, 'wb') as err:
            proc = subprocess.Popen(
                [sys.executable, '-m', 'handyrl_tpu_torch.serving', '--env',
                 'Geister', '--registry', root, '--port', '0'],
                cwd=repo, stdout=subprocess.PIPE, stderr=err)
        ready = read_ready_line(proc, timeout=300)
        if ready['device'] != 'cuda':
            fail('14(a): the service runs on %r' % ready['device'])
        client = ServiceClient('localhost', ready['port'], timeout=120,
                               name='chip_smoke_geister')
        env = make_env(dict(GEISTER_ENV, id=SEED + 142))
        env.reset()
        served = {p: None for p in env.players()}
        mine = {p: local.init_hidden() for p in env.players()}
        err, ms, boards = 0.0, [], []
        for ply in range(G_SERVE_PLIES):
            if env.terminal():
                break
            p = env.turn()
            obs = env.observation(p)
            boards.append(obs)
            t0 = time.perf_counter()
            out = client.request('default@champion', obs,
                                 hidden=served[p])['outputs']
            ms.append(1e3 * (time.perf_counter() - t0))
            want = local.inference(obs, mine[p])
            hs, cs = out['hidden']
            if len(hs) != 3 or np.shape(hs[0]) != (6, 6, net.filters):
                fail('14(a): the reply\'s DRC state is %s'
                     % [np.shape(h) for h in hs + cs])
            for a, b in ([(out['policy'], want['policy']),
                          (out['value'], want['value'])]
                         + list(zip(hs + cs, want['hidden'][0]
                                    + want['hidden'][1]))):
                err = max(err, float(np.abs(np.asarray(a)
                                            - np.asarray(b)).max()))
            served[p], mine[p] = out['hidden'], want['hidden']
            legal = env.legal_actions(p)
            env.play(legal[int(np.argmax(np.asarray(out['policy'])[legal]))])
        # a B=1 request against its row of a coalesced batch
        boards = (boards * G_BATCHED)[:G_BATCHED]
        alone = [client.request('default@champion', b)['outputs']['policy']
                 for b in boards]
        rids = [client.submit('default@champion', b) for b in boards]
        batched = [client.collect(r, timeout=120)['outputs']['policy']
                   for r in rids]
        row_err = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                      for a, b in zip(alone, batched))
        status = client.status()
        if not err <= POLICY_TOL:
            fail('14(a): the served outputs and state are off the CPU '
                 'forward by %.3g' % err)
        if not row_err <= POLICY_TOL:
            fail('14(a): a B=1 request is off its row of a batch by %.3g'
                 % row_err)
        if status['answered'] != status['received']:
            fail('14(a): unanswered requests: %s' % status)
        client.close()
        client = None
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        if rc != 75:
            fail('14(a): the service exited %d after SIGTERM' % rc)
        out = {'plies': len(ms), 'max_abs_err': err, 'row_max_abs_err':
               row_err, 'ply_ms': ms, 'requests': status['received'],
               'launches': status['kernel_launches']}
        log('14(a) served GeisterNet(batch, spatial) with its DRC state '
            '(%s): %s' % (nvidia_smi_line(), json.dumps(out)))
        return out
    finally:
        if client is not None:
            client.close()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


def check_moved_stats(torch, label, ckpt):
    """A 'batch' GeisterNet checkpoint read by the JAX-layout reader
    (``load_params_bytes``, flax's msgpack tree with its ``batch_stats``):
    every running average moved off its init (mean 0, var 1)."""
    from handyrl_tpu_torch.model import load_params_bytes
    net = geister_net(torch, 0)
    with open(ckpt, 'rb') as f:
        load_params_bytes(net, f.read())
    stale = [n for n, b in net.named_buffers()
             if torch.equal(b, torch.zeros_like(b) if n.endswith('mean')
                            else torch.ones_like(b))]
    if stale or not list(net.named_buffers()):
        fail('%s: running averages at their init: %s' % (label, stale))
    return {n: float(b.abs().mean()) for n, b in net.named_buffers()}


def geister_learners(torch, repo, tmp):
    """14(b) the host learner on the 'geister' row ('batch', 'spatial'),
    14(c) the fused 'turn' loop on 'geister-fused-sp-bn', its evaluator
    against 'random' and (b)'s checkpoint."""
    host_tmp = os.path.join(tmp, 'host')
    os.makedirs(host_tmp)
    line, _ = run_train_cli(repo, G_LEARNER, host_tmp, '14(b) host learner',
                            timeout=PHASE14_TIMEOUT)
    host = check_learner_line('14(b) Geister host learner', line, G_EPOCHS,
                              {'training': ('td_lambda',)})
    ckpt = os.path.join(host_tmp, 'models', 'latest.ckpt')
    host['stats'] = check_moved_stats(torch, '14(b)', ckpt)
    # once a step (the graph's replays and its eager warm-up steps)
    k3 = line['kernel_launches']['training']['td_lambda']
    if k3 < line['steps_at_exit']:
        fail('14(b): K3 launched %d times for %d steps'
             % (k3, line['steps_at_exit']))
    host['td_lambda_per_step'] = k3 / max(line['steps_at_exit'], 1)
    cfg = json.loads(json.dumps(G_FUSED))
    cfg['train_args']['eval'] = {'opponent': ['random', ckpt]}
    fused_tmp = os.path.join(tmp, 'fused')
    os.makedirs(fused_tmp)
    line, stdout = run_train_cli(repo, cfg, fused_tmp, '14(c) fused loop',
                                 timeout=PHASE14_TIMEOUT)
    if not line.get('fused') or '(turn mode)' not in stdout:
        fail('14(c): Geister did not run the fused loop in turn mode')
    fused = check_learner_line('14(c) Geister fused loop (turn mode)', line,
                               G_FUSED_EPOCHS, {'training': ('td_lambda',)})
    if 'win rate (%s)' % ckpt not in stdout or 'win rate (random)' \
            not in stdout:
        fail('14(c): the device evaluator did not play random and (b)\'s '
             'checkpoint')
    fused['stats'] = check_moved_stats(
        torch, '14(c)', os.path.join(fused_tmp, 'models', 'latest.ckpt'))
    fused['windows_ingested'] = line['windows_ingested']
    return host, fused


def geister_refresh(torch, repo):
    """14(c): an in-process fused 'turn' pipeline for Geister on the card:
    a warm chunk, a chunk with its 4 SGD steps, then ``refresh_actor``
    leaves the actor's parameters and running averages equal to the
    trainer's."""
    from handyrl_tpu_torch.config import apply_defaults
    from handyrl_tpu_torch.envs import torch_geister as tg
    from handyrl_tpu_torch.ops.device_windows import DeviceWindower
    from handyrl_tpu_torch.ops.fused_pipeline import FusedPipeline
    from handyrl_tpu_torch.ops.replay import (
        resolve_windows_per_episode, ring_capacity, windows_per_episode)
    from handyrl_tpu_torch.ops.train_step import (ReplayUpdateStep,
                                                  init_train_state)
    from handyrl_tpu_torch.train import loss_config
    raw = json.loads(json.dumps(G_FUSED))
    raw['train_args'].update(generation_envs=G_REFRESH['envs'],
                             device_chunk_steps=G_REFRESH['chunk'],
                             batch_size=G_REFRESH['batch'],
                             maximum_episodes=64)
    args = apply_defaults(raw)['train_args']
    resolve_windows_per_episode(args, tg)
    net = geister_net(torch, SEED + 143).cuda()
    actor = geister_net(torch, SEED + 144).cuda().eval()
    step = ReplayUpdateStep(net, loss_config(args)._replace(
        observation=False), init_train_state(net))
    windower = DeviceWindower(
        'turn', args['forward_steps'], args['burn_in_steps'], tg.MAX_PLIES,
        windows_per_episode(args), ring_capacity(args), tg.NUM_PLAYERS,
        args['gamma'], True)
    fp = FusedPipeline(tg, actor, step, windower, args['generation_envs'],
                       args['device_chunk_steps'], 4, args['batch_size'],
                       seed=SEED)
    for _ in range(64):      # until the ring holds a batch of windows
        fp.warm_step()
        if fp.ring_size_host >= args['batch_size']:
            break
    fp.train_step(float(args['batch_size'] * args['forward_steps']))
    torch.cuda.synchronize()
    trainer = step.state.params
    fp.refresh_actor(trainer)
    torch.cuda.synchronize()
    own = dict(actor.named_parameters())
    own.update(actor.named_buffers())
    if set(own) != set(trainer) or not all(torch.equal(own[k], trainer[k])
                                           for k in own):
        fail('14(c): the actor after refresh_actor differs from the '
             'trainer')
    start = geister_net(torch, SEED + 143).state_dict()
    moved = [n for n, _ in actor.named_buffers()
             if not torch.equal(trainer[n].cpu(), start[n])]
    if not moved:
        fail('14(c): the trainer\'s running averages never moved')
    out = {'ring_size': fp.ring_size_host, 'stats_moved': len(moved),
           'buffers': len(list(actor.named_buffers()))}
    fp.release()
    return out


def geister_step_batch(torch, B, T, seed):
    """A wide (observation: true) Geister batch on real-shaped planes:
    (B, T, 2, ...) with the acting seat alternating ply by ply."""
    import numpy as np
    rng = np.random.RandomState(seed)
    P = 2
    acting = np.zeros((B, T, P, 1), np.float32)
    acting[:, np.arange(T), np.arange(T) % 2] = 1
    board = (rng.rand(B, T, P, 7, 6, 6) < 0.2).astype(np.float32)
    board[..., 0, :, :] = 1
    scalar = (rng.rand(B, T, P, 18) < 0.3).astype(np.float32)
    first = np.sign(rng.randn(B, 1, 1, 1)).astype(np.float32)
    batch = {
        'observation': {'board': board * acting[..., None, None],
                        'scalar': scalar * acting},
        'selected_prob': np.where(acting > 0, rng.uniform(
            0.05, 1, (B, T, P, 1)), 1).astype(np.float32),
        'value': (rng.uniform(-1, 1, (B, T, P, 1)) * acting).astype(
            np.float32),
        'action': (rng.randint(0, 214, (B, T, P, 1)) * acting).astype(
            np.int32),
        'outcome': np.concatenate([first, -first], axis=2),
        'reward': np.full((B, T, P, 1), -0.01, np.float32),
        'return': np.zeros((B, T, P, 1), np.float32),
        'episode_mask': np.ones((B, T, 1, 1), np.float32),
        'turn_mask': acting, 'observation_mask': acting.copy(),
        'action_mask': np.zeros((B, T, P, 214), np.float32),
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0)}
    return batch


def to_device_batch(torch, batch, device):
    import numpy as np
    return {k: ({kk: torch.from_numpy(np.ascontiguousarray(vv)).to(device)
                 for kk, vv in v.items()} if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)).to(device))
            for k, v in batch.items()}


def stats_steps(torch, make_net, cfg, batch_np, device, lrs, graphed):
    """Update steps of ``make_net()`` on ``device`` from the same state,
    one an lr: eager or graphed. Returns (params before, [after a step:
    params and running averages, mu, nu, count, steps, metrics] on the
    CPU)."""
    from handyrl_tpu_torch.ops.train_step import (build_graphed_update_step,
                                                  build_update_step,
                                                  init_train_state)
    from handyrl_tpu_torch.ops.device_windows import flatten_window_keys
    net = make_net().to(device)
    state = init_train_state(net)
    batch = to_device_batch(torch, batch_np, device)
    if graphed:
        step = build_graphed_update_step(net, cfg, state)
        batch = flatten_window_keys(batch)
    else:
        update = build_update_step(net, cfg)

    def cpu(d):
        return {k: v.detach().cpu().clone() for k, v in d.items()}
    before = cpu(state.params)
    after = []
    for lr in lrs:
        lr = torch.tensor(lr, device=device)
        if graphed:
            metrics = step(batch, lr)
            state = step.state
        else:
            state, metrics = update(state, batch, lr)
        after.append({'params': cpu(state.params),
                      'mu': cpu(state.opt_state.mu),
                      'nu': cpu(state.opt_state.nu),
                      'count': int(state.opt_state.count),
                      'steps': int(state.steps),
                      'metrics': {k: float(v) for k, v in metrics.items()}})
    return before, after, (step if graphed else None)


def check_stats(label, card, cpu, names):
    """The running averages after a card step against the CPU step's:
    each leaf within STATS_RTOL of its largest element."""
    worst = max(((card['params'][k] - cpu['params'][k]).abs().max()
                 / cpu['params'][k].abs().max().clamp_min(1e-30)).item()
                for k in names)
    if not worst <= STATS_RTOL:
        fail('%s: the running averages on the card are off the CPU\'s by '
             '%.3g of a leaf' % (label, worst))
    return worst


def bn_step_checks(torch, label, make_net, cfg, batch_np, kernel, lr):
    """(d)/(e): eager and graphed steps of a 'batch' net on the card (3
    each, the counts 0 just before the graphed ones), held to each other
    and the first to the CPU step (phase 4's tolerances for the loss terms,
    the params and Adam's moments; STATS_RTOL for the running averages);
    then the graph's replays timed by CUDA events. Returns the row."""
    from handyrl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    lrs = [lr] * 3
    old, cpu_after, _ = stats_steps(torch, make_net, cfg, batch_np, 'cpu',
                                    lrs[:1], False)
    _, eager, _ = stats_steps(torch, make_net, cfg, batch_np, 'cuda', lrs,
                              False)
    reset_kernel_launches()
    _, graphed, step = stats_steps(torch, make_net, cfg, batch_np, 'cuda',
                                   lrs, True)
    torch.cuda.synchronize()
    launches = kernel_launches()
    names = [k for k in old if k not in cpu_after[0]['mu']]
    if not names:
        fail('%s: the net has no running averages' % label)
    moved = [k for k in names if torch.equal(old[k], eager[0]['params'][k])]
    if moved:
        fail('%s: the step left running averages unchanged: %s'
             % (label, moved))
    check_against_cpu(label, old, eager[0], cpu_after[0], lr=lr)
    stats_err = check_stats(label, eager[0], cpu_after[0], names)
    worst = check_graphed_against_eager(label, graphed, eager)
    if launches.get(kernel, 0) < 3 or any(
            n for k, n in launches.items() if k != kernel):
        fail('%s: launches %s (want %s once a step and nothing else)'
             % (label, launches, kernel))
    from handyrl_tpu_torch.ops.device_windows import flatten_window_keys
    batch = flatten_window_keys(to_device_batch(torch, batch_np, 'cuda'))
    lr_t = torch.tensor(lr, device='cuda')
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    step(batch, lr_t)
    torch.cuda.synchronize()
    start.record()
    for _ in range(G_STEP_REPS):
        step(batch, lr_t)
    end.record()
    torch.cuda.synchronize()
    row = {'graphed_ms': start.elapsed_time(end) / G_STEP_REPS,
           'reps': G_STEP_REPS, 'stats_max_rel_err': stats_err,
           'graphed_vs_eager': worst, 'launches': launches,
           'total': eager[0]['metrics']['total']}
    log('%s (%s): %s' % (label, nvidia_smi_line(), json.dumps(row)))
    return row


def geister_recurrent_step(torch):
    """14(d): the full-width GeisterNet('batch', 'spatial') recurrent step
    at B=32, T=16+4 (burn-in 4), the wide observation layout, TD/TD."""
    from handyrl_tpu_torch.ops.losses import LossConfig
    cfg = LossConfig(turn_based_training=True, observation=True,
                     burn_in_steps=4, gamma=0.8)
    batch = geister_step_batch(torch, G_STEP_B, 20, SEED + 145)
    return bn_step_checks(torch, '14(d) GeisterNet recurrent step',
                          lambda: geister_net(torch, SEED + 146,
                                              stats_seed=SEED + 147),
                          cfg, batch, 'td_lambda', 1e-5)


def geese_bn_step(torch):
    """14(e): GeeseNet(norm_kind 'batch', torus_impl 'pad') at full width,
    one solo VTRACE window batch (B=16, T=16), graphed and held to the CPU
    step (K5)."""
    import numpy as np
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.ops.losses import LossConfig
    B, T = GEESE_BN_B, 16
    rng = np.random.RandomState(SEED + 148)
    ones = np.ones((B, T, 1, 1), np.float32)
    batch = {
        'observation': (rng.rand(B, T, 1, 17, 7, 11) < 0.15).astype(
            np.float32),
        'selected_prob': rng.uniform(0.1, 1, (B, T, 1, 1)).astype(
            np.float32),
        'value': rng.uniform(-1, 1, (B, T, 1, 1)).astype(np.float32),
        'action': rng.randint(0, 4, (B, T, 1, 1)).astype(np.int32),
        'outcome': np.sign(rng.randn(B, 1, 1, 1)).astype(np.float32),
        'reward': np.zeros((B, T, 1, 1), np.float32),
        'return': np.zeros((B, T, 1, 1), np.float32),
        'episode_mask': ones, 'turn_mask': ones, 'observation_mask': ones,
        'action_mask': np.zeros((B, T, 1, 4), np.float32),
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0)}
    cfg = LossConfig(turn_based_training=False, observation=True,
                     policy_target='VTRACE', value_target='VTRACE',
                     gamma=0.99)
    return bn_step_checks(
        torch, '14(e) GeeseNet(batch, pad) VTRACE step',
        lambda: GeeseNet(norm_kind='batch', torus_impl='pad',
                         generator=torch.Generator().manual_seed(
                             SEED + 149)), cfg, batch, 'vtrace', 1e-5)


PTTT_EPOCHS = 1           # 2 until phase 17 needed the time (PERF.md §4)


def parallel_tictactoe_learner(repo, tmp):
    """14(f): the host learner on tictactoe.json's train_args, not
    turn-based, on ParallelTicTacToe, PTTT_EPOCHS epochs: K3 in
    training."""
    cfg = quick_config(repo, {'turn_based_training': False}, PTTT_EPOCHS)
    cfg['env_args'] = {'env': 'ParallelTicTacToe'}
    ptt_tmp = os.path.join(tmp, 'ptt')
    os.makedirs(ptt_tmp)
    line, _ = run_train_cli(repo, cfg, ptt_tmp, '14(f) ParallelTicTacToe',
                            timeout=PHASE14_TIMEOUT)
    return check_learner_line('14(f) ParallelTicTacToe host learner', line,
                              PTTT_EPOCHS, {'training': ('td_lambda',)})


def geister_device_actor(torch, make_env):
    """14(g): one block of DA_LANES Geister tasks on recurrent lanes
    ('device' records; 'e' tasks against 'random'), the counts 0 just
    before: every lane answered, each episode stamped and its moments the
    acting seat's alone, no kernel launched (GeisterNet has none)."""
    from handyrl_tpu_torch.device_generation import DeviceActorEngine
    from handyrl_tpu_torch.environment import make_device_env
    from handyrl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from handyrl_tpu_torch.ops.batch import decompress_moments
    ta = da_train_args(GEISTER_ENV, {'observation': True,
                                     'burn_in_steps': 4})

    def build():
        return geister_net(torch, 0)
    vault = da_vault(torch, make_env, GEISTER_ENV, build, SEED + 150)
    eng = DeviceActorEngine(make_device_env(GEISTER_ENV), vault,
                            make_env(GEISTER_ENV), ta, n_envs=DA_LANES,
                            chunk_steps=DA_CHUNK, slots=DA_SLOTS,
                            seed=SEED, device=DA_DEVICE)
    if not eng.recurrent or eng.record_mode != 'device':
        fail('14(g): the Geister engine runs %r records (recurrent %s)'
             % (eng.record_mode, eng.recurrent))
    tasks = da_tasks(4, (1, 2), 2, opponents=('random', 'random'))
    reset_kernel_launches()
    t0 = time.monotonic()
    uploads, deferred = eng.run_block(tasks)
    block_s = time.monotonic() - t0
    launches = kernel_launches()
    if deferred or len(uploads) != DA_LANES or any(
            p is None for _, p in uploads):
        fail('14(g): the block deferred %d tasks, %d uploads'
             % (len(deferred), len(uploads)))
    for task, (kind, payload) in zip(tasks, uploads):
        if kind != 'episode':
            continue
        if payload.get('record_version') != 1:
            fail('14(g): a Geister episode without record_version 1')
        for m in decompress_moments(payload['moment']):
            (p,) = m['turn']
            if m['observation'][1 - p] is not None:
                fail('14(g): a moment where the other seat observed')
    if any(launches.values()):
        fail('14(g): kernels launched by GeisterNet lanes: %s' % launches)
    st = eng.stats
    out = {'episodes': st['episodes'], 'results': st['results'],
           'chunks': st['chunks'], 'graph_captures': eng.captures,
           'block_seconds': block_s,
           'fill_ratio': eng.last_block['fill_ratio'],
           'chunk_ms': eng.last_block['chunk_ms'][:4], 'launches': launches}
    log('14(g) device actor, Geister lanes: %s' % json.dumps(out))
    return out


def geister_learner_group(torch, repo, tmp):
    """14(b)/(c) and 14(f) at once: learner processes of their own (the
    checks in this process read their lines and checkpoints on the host,
    no CUDA work), so the group can run beside phase 13."""
    return concurrently(lambda: geister_learners(torch, repo, tmp),
                        lambda: parallel_tictactoe_learner(repo, tmp))


def phase_geister(torch, repo, make_env, learners):
    """Phase 14: Geister and ParallelTicTacToe, BatchNorm through the step,
    the checkpoints and inference; each part's seconds, one JSON line.
    ``learners()`` waits for :func:`geister_learner_group` (started beside
    phase 13); 'b_c_f' is the wait left in this phase."""
    from handyrl_tpu_torch.model import fp32_on_card
    fp32_on_card(torch.device('cuda'))
    t0 = time.monotonic()
    seconds = {}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_geister_')
    try:
        log('== phase 14(a): GeisterNet(batch, spatial) served with its DRC '
            'state')
        t = time.monotonic()
        serving = geister_serving(torch, repo, make_env)
        seconds['a'] = time.monotonic() - t
        log('== phase 14(b)/(c), with 14(f) at once (begun beside phase '
            '13): Geister on the host learner and the fused turn loop; '
            'ParallelTicTacToe on the host learner')
        t = time.monotonic()
        (host, fused), ptt = learners()
        seconds['b_c_f'] = time.monotonic() - t
        t = time.monotonic()
        fused['refresh'] = geister_refresh(torch, repo)
        log('14(c) refresh_actor: %s' % json.dumps(fused['refresh']))
        seconds['c_refresh'] = time.monotonic() - t
        log('== phase 14(d)/(e): the recurrent GeisterNet step and the '
            'GeeseNet(batch) step')
        t = time.monotonic()
        step = geister_recurrent_step(torch)
        geese = geese_bn_step(torch)
        seconds['d_e'] = time.monotonic() - t
        log('== phase 14(g): the device actor on Geister lanes')
        t = time.monotonic()
        actor = geister_device_actor(torch, make_env)
        seconds['g'] = time.monotonic() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds['total'] = time.monotonic() - t0
    out = {'phase': 14, 'serving': serving, 'host': host, 'fused': fused,
           'step': step, 'geese_bn': geese, 'parallel_tictactoe': ptt,
           'actor': actor, 'seconds': seconds, 'card': nvidia_smi_line()}
    print(json.dumps(out), flush=True)
    return out


# ------------------------------------------------ phase 15: bf16, GeeseFormer

# (a) the bf16 kernels at the serving bucket (8), a generation batch (256:
# 64 envs x 4 geese) and the fused loop's step (1,024: B=64 x T=16)
BF16_NS = (8, 256, 1024)
BF16_MAIN_N = 8          # the kernels line's K1 row (serving)
BF16_TRAIN_N = 1024      # ... and its K2 rows (the fused loop's step)
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores, dense
# The bf16 kernels against their plain bf16 versions, each output (y, and
# each grad of K2) by its max abs error over its largest element. Both
# round to bf16 (8 significant bits) at the same points but sum the taps
# and the statistics in other orders, so a value near a rounding boundary
# rounds one ulp (2^-8 relative) the other way and 13 normalised layers
# carry it on: an H100 run saw 1.2% for y and 0.7% for the grads at full
# width; the bound leaves about twice that. y's mean abs
# error over its mean |y| within BF16_MEAN_TOL (one ulp).
BF16_TOL = 2.0 ** -5
BF16_MEAN_TOL = 2.0 ** -8
# (c) the bf16 step on the card against the CPU's bf16 step: the loss
# terms within BF16_STEP_RTOL of max(|total|, |v|, 1), the grad norm of
# itself; Adam's first moment leaf by leaf within BF16_MU_RTOL of its
# largest element (the grads carry the kernels' bf16 roundings above: a
# leaf of few elements, such as a norm's scale, has no large element to
# dwarf a flipped rounding; 5.1% seen on an H100, the loss terms within
# 0.2%); the params within 2 lr (Adam's first step is g /
# (|g| + 1e-8): a grad within bf16 rounding of 0 may take the other
# sign) plus BF16_PARAM_SLACK, an fp32 ulp of a param of size 1 (the
# first card run saw 2 lr + 2.7e-8).
BF16_STEP_RTOL = 2e-2
BF16_MU_RTOL = 1e-1
BF16_PARAM_SLACK = 1.2e-7
BF16_FUSED_EPOCHS = 3    # (d): the north-star config cut to 3 epochs
BF16_TTT = {             # (e): tests/test_bf16.py's config
    'env_args': {'env': 'TicTacToe'},
    'train_args': {'batch_size': 8, 'update_episodes': 20,
                   'minimum_episodes': 20, 'epochs': 1,
                   'generation_envs': 8, 'forward_steps': 8,
                   'num_batchers': 1, 'compute_dtype': 'bfloat16',
                   'seed': SEED}}
FORMER_PLIES = 6         # (f): plies of served four-goose play
# (g): the fused loop at the north-star config, 3 epochs: it reports an
# epoch's losses one dispatch late, so a run of 2 closes with none
FORMER_EPOCHS = 3
FORMER_STEP = (64, 16)   # (g): the graphed VTRACE step's B, T
FORMER_STEP_REPS = 20


def bf16_trunk_bound_ms(n, cin, filters, layers, groups, training=False):
    """Least time for K1's bf16 form at batch n: its products over the
    dense bf16 peak, its bytes (x, the output and the saved block inputs
    2 bytes an element; the weights, xhat and rstd 4) over the HBM rate."""
    flops = n * 2 * 77 * 9 * (cin * filters + layers * filters * filters)
    weights = 9 * cin * filters + layers * 9 * filters * filters \
        + 2 * filters * (layers + 1)
    nbytes = 2 * n * 77 * (cin + filters) + 4 * weights
    if training:
        nbytes += n * (2 * layers * 77 * filters
                       + 4 * (layers + 1) * (77 * filters + groups))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def bf16_bwd_bounds_ms(n, cin, filters, layers, groups):
    """K2's bf16 form's two phases at batch n, as :func:`bwd_bounds_ms`
    with the products over the dense bf16 peak and 2 bytes an element of
    x, acts, y, dy and dc (xhat, rstd, the weights and the grads 4)."""
    nl = layers + 1
    weights = 9 * cin * filters + layers * 9 * filters * filters
    grads = weights + 2 * filters * nl
    px = 77 * filters
    a_flops = n * 2 * 77 * 9 * layers * filters * filters
    a_bytes = (n * (4 * nl * px + 4 * nl * groups + 2 * layers * px
                    + 4 * px + 2 * nl * px + 4 * nl * 2 * filters)
               + 4 * (weights + 2 * nl * filters))
    b_flops = n * 2 * 77 * 9 * (cin * filters + layers * filters * filters)
    b_bytes = (n * (2 * 77 * cin + 2 * layers * px + 2 * nl * px
                    + 4 * nl * 2 * filters) + 4 * grads)
    out = {}
    for phase, flops, nbytes in (('a', a_flops, a_bytes),
                                 ('b', b_flops, b_bytes)):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[phase] = (1e3 * max(t_ops, t_bytes),
                      'operations' if t_ops >= t_bytes else 'bytes', flops,
                      nbytes)
    return out


def rel_err(torch, got, ref):
    """max |got - ref| over max |ref|, in fp32."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
            ).item()


def bf16_forward_row(torch, geese_trunk, net, weights, x, n):
    """15(a): K1's bf16 form (serving and training) at batch n against its
    plain bf16 version, timed beside the plain version and the 'pad' trunk
    in bf16 (cuDNN's bf16 convs and the bf16 norms)."""
    G, L, F = WIDTH['groups'], WIDTH['layers'], WIDTH['filters']
    xb = x.to(torch.bfloat16)

    def kernel():
        return geese_trunk.trunk_forward(xb, *weights, groups=G)

    def plain():
        return geese_trunk.trunk_forward_reference(xb, *weights, groups=G)

    def library():
        return net.trunk(x)

    def training():
        return geese_trunk.trunk_forward(xb, *weights, groups=G, **saved)

    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    if got.dtype != torch.bfloat16 or not bool(
            torch.isfinite(got.float()).all().item()):
        fail('15(a) K1 bf16 at N=%d: %s output, or non-finite' % (n,
                                                                  got.dtype))
    err = rel_err(torch, got, ref)
    mean_err = ((got.float() - ref.float()).abs().mean()
                / ref.float().abs().mean()).item()
    lib_err = rel_err(torch, library(), ref)
    saved = geese_trunk.training_buffers(n, L, F, G, x.device,
                                         torch.bfloat16)
    ref_saved = geese_trunk.training_buffers(n, L, F, G, x.device,
                                             torch.bfloat16)
    y = training()
    torch.cuda.synchronize()
    geese_trunk.trunk_forward_reference(xb, *weights, groups=G, **ref_saved)
    if not torch.equal(y, got):
        fail('15(a) K1 bf16 at N=%d: the training form\'s output is not the '
             'serving form\'s' % n)
    saved_err = {'acts': rel_err(torch, saved['acts'], ref_saved['acts']),
                 'xhat': rel_err(torch, saved['xhat'], ref_saved['xhat']),
                 'rstd': rel_err(torch, saved['rstd'], ref_saved['rstd'])}
    bound, bound_by, flops, nbytes = bf16_trunk_bound_ms(
        n, WIDTH['cin'], F, L, G)
    tb = bf16_trunk_bound_ms(n, WIDTH['cin'], F, L, G, training=True)
    row = {'n': n, 'max_abs_err': err, 'mean_err': mean_err,
           'library_err': lib_err, 'saved_err': saved_err,
           'ms': cuda_time_ms(torch, kernel, 100),
           'train_ms': cuda_time_ms(torch, training, 50),
           'plain_ms': cuda_time_ms(torch, plain, 5),
           'library_ms': cuda_time_ms(torch, library, 20),
           'bound_ms': bound, 'bound_by': bound_by, 'train_bound_ms': tb[0],
           'flops': flops, 'bytes': nbytes}
    log('geese_trunk_bf16 N=%-4d err %.3g of max |y| (tol %.3g), mean %.3g '
        '(tol %.3g); pad-trunk bf16 vs plain %.3g; saved %s  kernel %.4f '
        'ms, training form %.4f ms, plain %.4f ms, library %.4f ms, bound '
        '%.4f ms (%s), training bound %.4f ms' % (
            n, err, BF16_TOL, mean_err, BF16_MEAN_TOL, lib_err,
            json.dumps({k: round(v, 6) for k, v in saved_err.items()}),
            row['ms'], row['train_ms'], row['plain_ms'], row['library_ms'],
            bound, bound_by, tb[0]))
    if not (err <= BF16_TOL and mean_err <= BF16_MEAN_TOL
            and max(saved_err.values()) <= BF16_TOL):
        fail('15(a) K1 bf16 disagrees with its plain bf16 version at N=%d'
             % n)
    return row, xb, y, saved


def bf16_backward_row(torch, geese_trunk, net, weights, x, xb, y, saved, n,
                      gen):
    """15(a): K2's bf16 form at batch n from K1's bf16 training forward,
    every grad against the plain bf16 backward on the same saved tensors;
    its phases timed by the profiler; the whole K2 beside the plain
    version and autograd through the 'pad' trunk in bf16, K2b beside the
    13 plain weight grads and cuDNN's bf16 weight grads."""
    import torch.nn.functional as F
    G, L, Fw = WIDTH['groups'], WIDTH['layers'], WIDTH['filters']
    dy = torch.randn(n, 7, 11, Fw, generator=gen).cuda().to(torch.bfloat16)
    kw = dict(acts=saved['acts'], y=y, xhat=saved['xhat'],
              rstd=saved['rstd'])
    names = ('dx', 'd_stem_w', 'd_stem_scale', 'd_stem_bias', 'd_block_w',
             'd_block_scale', 'd_block_bias')

    def kernel(need_dx=False):
        return geese_trunk.trunk_backward(xb, *weights, dy, groups=G,
                                          need_dx=need_dx, **kw)

    def plain():
        return geese_trunk.trunk_backward_reference(
            xb, *weights, dy, groups=G, need_dx=False, **kw)

    with torch.no_grad():
        got = kernel(need_dx=True)
        torch.cuda.synchronize()
        ref = geese_trunk.trunk_backward_reference(xb, *weights, dy,
                                                   groups=G, **kw)
        errs = {}
        for name, g, r in zip(names, got, ref):
            if not bool(torch.isfinite(g.float()).all().item()):
                fail('15(a) K2 bf16: non-finite %s at N=%d' % (name, n))
            want = torch.bfloat16 if name == 'dx' else torch.float32
            if g.dtype != want:
                fail('15(a) K2 bf16: %s is %s' % (name, g.dtype))
            errs[name] = rel_err(torch, g, r)
        ms = cuda_time_ms(torch, kernel, 20)
        plain_ms = cuda_time_ms(torch, plain, 3)
        by_kernel = k2_kernel_ms(torch, kernel, 10, '15(a) K2 bf16 N=%d' % n)
        inputs, dcs = layer_inputs_and_dc(geese_trunk, xb, weights, dy, G,
                                          dict(kw), bf16=True)
        padded = [F.pad(h.permute(0, 3, 1, 2).contiguous(), (1, 1, 1, 1),
                        mode='circular') for h in inputs]
        dcs_nchw = [d.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()
                    for d in dcs]
        sizes = [(d.shape[-1], h.shape[-1], 3, 3)
                 for h, d in zip(inputs, dcs)]
        ref_w = [ref[1]] + list(ref[4])

        def b_plain():
            return [geese_trunk._conv_weight_grad(h.float(), d)
                    for h, d in zip(inputs, dcs)]

        def b_library():
            return [torch.nn.grad.conv2d_weight(p, s, d)
                    for p, s, d in zip(padded, sizes, dcs_nchw)]
        b_lib_err = max(rel_err(torch, g.permute(2, 3, 1, 0), r)
                        for g, r in zip(b_library(), ref_w))
        b_plain_ms = cuda_time_ms(torch, b_plain, 5)
        b_library_ms = graph_time_ms(torch, b_library, 20)
        del inputs, dcs, padded, dcs_nchw
    with torch.enable_grad():
        yp = net.trunk(x)
        library_ms = cuda_time_ms(torch, lambda: torch.autograd.grad(
            yp, weights, dy, retain_graph=True), 5)
    del yp
    err = max(errs.values())
    bounds = bf16_bwd_bounds_ms(n, WIDTH['cin'], Fw, L, G)
    row = {'n': n, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
           'library_ms': library_ms, 'errs': errs}
    for phase, kernels in PHASES.items():
        times = [t for k, t in by_kernel.items()
                 if any(name in k for name in kernels)]
        if len(times) != len(kernels):
            fail('15(a): the profiler shows %d of K2 bf16 phase %s\'s '
                 'kernels %s: %s' % (len(times), phase, kernels,
                                     sorted(by_kernel)))
        bound, bound_by, flops, nbytes = bounds[phase]
        row[phase] = {'ms': sum(times), 'bound_ms': bound,
                      'bound_by': bound_by, 'flops': flops, 'bytes': nbytes}
    row['b'].update(plain_ms=b_plain_ms, library_ms=b_library_ms,
                    library_err=b_lib_err)
    log('geese_trunk_bwd_bf16 N=%-4d err / max |grad| %.3g (tol %.3g; %s)  '
        'kernel %.4f ms (a %.4f, b %.4f by the profiler; bounds %.4f, '
        '%.4f)  plain %.4f ms  library %.4f ms; K2b plain %.4f ms, cuDNN '
        'bf16 weight grads %.4f ms (err %.3g)' % (
            n, err, BF16_TOL, ', '.join('%s %.2g' % kv for kv in
                                        errs.items()), ms, row['a']['ms'],
            row['b']['ms'], row['a']['bound_ms'], row['b']['bound_ms'],
            plain_ms, library_ms, b_plain_ms, b_library_ms, b_lib_err))
    if not err <= BF16_TOL:
        fail('15(a) K2 bf16 disagrees with its plain bf16 version at N=%d'
             % n)
    return row


def bf16_kernels(torch, geese_trunk, GeeseNet, make_env):
    """15(a): the bf16 forms of K1 (both forms), K2a and K2b at full width
    on real boards, N in BF16_NS. Returns ({n: K1 row}, {n: K2 row})."""
    import numpy as np
    from handyrl_tpu_torch.models.blocks import set_compute_dtype
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net, weights = trunk_net(torch, GeeseNet)
    set_compute_dtype(net, torch.bfloat16)   # the 'pad' yardstick in bf16
    all_obs = np.stack(game_observations(make_env, max(BF16_NS), SEED + 151))
    gen = torch.Generator().manual_seed(SEED + 152)
    fwd, bwd = {}, {}
    for n in BF16_NS:
        x = torch.from_numpy(all_obs[:n]).cuda().permute(0, 2, 3, 1) \
            .contiguous()
        with torch.no_grad():
            fwd[n], xb, y, saved = bf16_forward_row(torch, geese_trunk, net,
                                                    weights, x, n)
        bwd[n] = bf16_backward_row(torch, geese_trunk, net, weights, x, xb,
                                   y, saved, n, gen)
    return fwd, bwd


def check_bf16_step(label, old, card, cpu, lr):
    """A bf16 update step on the card against the CPU's bf16 step under the
    BF16_STEP_* bounds; every param and moment fp32. Returns the errors."""
    import torch
    m, cm = card['metrics'], cpu['metrics']
    scale = max(abs(cm['total']), abs(cm['v']), 1.0)
    errs = {k: abs(m[k] - cm[k]) / scale for k in ('total', 'p', 'v', 'ent')}
    errs['diag_grad_norm'] = (abs(m['diag_grad_norm'] - cm['diag_grad_norm'])
                              / max(cm['diag_grad_norm'], 1e-30))
    step_max = max((card['params'][k] - cpu['params'][k]).abs().max().item()
                   for k in card['params'])
    mu_by_leaf = {k: ((card['mu'][k] - cpu['mu'][k]).abs().max()
                      / cpu['mu'][k].abs().max().clamp_min(1e-30)).item()
                  for k in card['mu']}
    mu = max(mu_by_leaf.values())
    dtypes = {t.dtype for d in (card['params'], card['mu'], card['nu'])
              for t in d.values()}
    out = {'terms': errs, 'params_max_abs': step_max, 'mu_rel': mu,
           'mu_rel_by_leaf': mu_by_leaf,
           'dtypes': sorted(str(d) for d in dtypes)}
    log('%s card vs CPU (bf16): %s' % (label, json.dumps(out)))
    if m['nonfinite'] or cm['nonfinite']:
        fail('%s hit the non-finite guard' % label)
    if dtypes != {torch.float32}:
        fail('%s: params or Adam moments not fp32: %s' % (label, dtypes))
    if not (max(errs.values()) <= BF16_STEP_RTOL
            and step_max <= 2 * lr + BF16_PARAM_SLACK
            and mu <= BF16_MU_RTOL and cm['diag_grad_norm'] > 0):
        fail('%s: the bf16 step on the card disagrees with the CPU\'s'
             % label)
    return out


def bf16_step(torch, make_env):
    """15(c): the headline step in bf16 at B=16 on real boards, TD/TD: one
    CPU step, 3 eager and 3 graphed card steps (the counts 0 just before
    the graphed ones), each card form's first step held to the CPU's and
    the graphed steps to the eager ones; then the graph's replays timed by
    CUDA events."""
    import numpy as np
    from handyrl_tpu_torch import bench
    from handyrl_tpu_torch.bench import LR
    from handyrl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from handyrl_tpu_torch.ops.train_step import build_graphed_update_step
    obs = np.stack(game_observations(make_env, STEP_B * 16, SEED + 153))
    obs = obs.reshape(STEP_B, 16, 1, 17, 7, 11)
    bf = dict(compute_dtype='bfloat16')
    _, cpu = card_steps(torch, 'cpu', 'TD', 'TD', obs, (LR,), **bf)
    old, eager = card_steps(torch, 'cuda', 'TD', 'TD', obs, (LR,) * 3, **bf)
    reset_kernel_launches()
    _, graphed = card_steps(torch, 'cuda', 'TD', 'TD', obs, (LR,) * 3,
                            graphed=True, **bf)
    torch.cuda.synchronize()
    launches = kernel_launches()
    out = {'eager': check_bf16_step('15(c) eager', old, eager[0], cpu[0], LR),
           'graphed': check_bf16_step('15(c) graphed', old, graphed[0],
                                      cpu[0], LR)}
    worst = 0.0
    for g, e in zip(graphed, eager):
        worst = max([worst] + [(g['params'][k] - e['params'][k]).abs().max()
                               .item() for k in g['params']])
    if not worst <= 2 * LR + BF16_PARAM_SLACK:
        fail('15(c): the graphed bf16 steps move the params unlike the eager '
             'ones by %.3g' % worst)
    want = ('geese_trunk_bf16', 'geese_trunk_bwd_bf16', 'td_lambda')
    if any(launches[k] < 3 for k in want) or launches['geese_trunk'] or \
            launches['geese_trunk_bwd']:
        fail('15(c): the graphed bf16 steps launched %s' % launches)
    net, cfg, batch, state = bench.headline_setup('cuda', B=STEP_B, **bf)
    batch['observation'] = torch.from_numpy(obs).cuda()
    step = build_graphed_update_step(net, cfg, state)
    lr = torch.tensor(LR, device='cuda')
    step(batch, lr)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(G_STEP_REPS):
        step(batch, lr)
    end.record()
    torch.cuda.synchronize()
    out.update(graphed_vs_eager_params=worst, launches=launches,
               graphed_ms=start.elapsed_time(end) / G_STEP_REPS)
    log('15(c) bf16 step B=%d (%s): graphed %.3f ms a step; graphed vs eager '
        'params %.3g; launches %s' % (STEP_B, nvidia_smi_line(),
                                      out['graphed_ms'], worst, launches))
    return out


def bf16_fused(repo, tmp):
    """15(d): the fused loop at the north-star config (phase 6) in bf16,
    cut to BF16_FUSED_EPOCHS epochs."""
    cfg = json.loads(json.dumps(FUSED_CONFIG))
    cfg['train_args'].update(epochs=BF16_FUSED_EPOCHS,
                             checkpoint_interval=BF16_FUSED_EPOCHS,
                             compute_dtype='bfloat16')
    line, stdout = run_train_cli(repo, cfg, tmp, '15(d) fused bf16')
    if not line.get('fused') or '(solo mode)' not in stdout:
        fail('15(d): the bf16 learner did not run the fused loop')
    out = check_learner_line(
        '15(d) fused loop, bf16', line, BF16_FUSED_EPOCHS,
        {'generation': ('geese_trunk_bf16',),
         'evaluation': ('geese_trunk_bf16',),
         'training': ('geese_trunk_bf16', 'geese_trunk_bwd_bf16', 'vtrace')})
    out['steps'] = line['steps']
    return out


def bf16_tictactoe(torch, tmp):
    """15(e): TicTacToe's host learner in bf16 in this process
    (tests/test_bf16.py's config, 1 epoch): the net runs bf16, every param
    and Adam moment stays fp32."""
    from handyrl_tpu_torch.config import apply_defaults
    from handyrl_tpu_torch.models.blocks import compute_dtype_of
    from handyrl_tpu_torch.ops import reset_kernel_launches
    from handyrl_tpu_torch.train import Learner
    raw = json.loads(json.dumps(BF16_TTT))
    raw['train_args']['model_dir'] = os.path.join(tmp, 'models')
    learner = Learner(apply_defaults(raw), device='cuda')
    if compute_dtype_of(learner.module) != torch.bfloat16:
        fail('15(e): the learner\'s net runs %s'
             % compute_dtype_of(learner.module))
    reset_kernel_launches()
    t0 = time.monotonic()
    learner.run()
    line = dict(learner.summary(), wall=time.monotonic() - t0)
    state = learner.trainer.update_step.state if \
        learner.trainer.update_step is not None else None
    dtypes = {t.dtype for t in learner.params.values()}
    if state is not None:
        dtypes |= {t.dtype for d in (state.params, state.opt_state.mu,
                                     state.opt_state.nu) for t in d.values()}
    if learner.model_epoch != 1 or dtypes != {torch.float32}:
        fail('15(e): model epoch %d, params and moments %s'
             % (learner.model_epoch, dtypes))
    out = check_learner_line('15(e) TicTacToe host learner, bf16', line, 1,
                             {'training': ('td_lambda',)})
    out['dtypes'] = sorted(map(str, dtypes))
    return out


def former_net(torch, seed):
    from handyrl_tpu_torch.models.transformer import GeeseFormer
    return GeeseFormer(generator=torch.Generator().manual_seed(seed))


def former_serving(torch, repo, make_env):
    """15(f): a full-width GeeseFormer snapshot in a temporary registry,
    served by ``python -m handyrl_tpu_torch.serving`` on the card: four
    geese for FORMER_PLIES plies, each reply's policy and value within
    POLICY_TOL of a CPU forward, no kernel launched (GeeseFormer has
    none)."""
    import numpy as np
    from handyrl_tpu_torch.model import ModelWrapper
    from handyrl_tpu_torch.serving.client import ServiceClient
    from handyrl_tpu_torch.serving.registry import ModelRegistry
    local = ModelWrapper(former_net(torch, SEED + 154), device='cpu')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_former_serve_')
    proc, client = None, None
    try:
        root = os.path.join(tmp, 'registry')
        ModelRegistry(root).publish('default', snapshot=local.snapshot(),
                                    version=1, promote=True)
        with open(os.path.join(tmp, 'service.err'), 'wb') as err:
            proc = subprocess.Popen(
                [sys.executable, '-m', 'handyrl_tpu_torch.serving', '--env',
                 'HungryGeese', '--registry', root, '--port', '0'],
                cwd=repo, stdout=subprocess.PIPE, stderr=err)
        ready = read_ready_line(proc, timeout=300)
        if ready['device'] != 'cuda':
            fail('15(f): the service runs on %r' % ready['device'])
        client = ServiceClient('localhost', ready['port'], timeout=120,
                               name='chip_smoke_former')
        env = make_env({'env': 'HungryGeese', 'id': SEED + 155})
        env.reset()
        err, ms, replies = 0.0, [], 0
        for _ in range(FORMER_PLIES):
            if env.terminal():
                break
            t0 = time.perf_counter()
            actions = {}
            for p in env.turns():
                obs = env.observation(p)
                out = client.request('default@champion', obs)['outputs']
                want = local.inference(obs)
                for k in ('policy', 'value'):
                    err = max(err, float(np.abs(np.asarray(out[k])
                                                - want[k]).max()))
                actions[p] = int(np.argmax(np.asarray(out['policy'])))
                replies += 1
            ms.append(1e3 * (time.perf_counter() - t0))
            env.step(actions)
        status = client.status()
        if not err <= POLICY_TOL:
            fail('15(f): served GeeseFormer is off the CPU forward by %.3g'
                 % err)
        if status['answered'] != status['received'] or any(
                status['kernel_launches'].values()):
            fail('15(f): the service answered %s' % status)
        client.close()
        client = None
        proc.send_signal(signal.SIGTERM)
        if proc.wait(timeout=120) != 75:
            fail('15(f): the service did not exit 75 after SIGTERM')
        out = {'replies': replies, 'max_abs_err': err, 'ply_ms': ms,
               'launches': status['kernel_launches']}
        log('15(f) served GeeseFormer (%s): %s' % (nvidia_smi_line(),
                                                   json.dumps(out)))
        return out
    finally:
        if client is not None:
            client.close()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def former_batch(make_env, B, T, seed):
    """A solo VTRACE window batch of real boards, (B, T, 1, ...)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    obs = np.stack(game_observations(make_env, B * T, seed))
    ones = np.ones((B, T, 1, 1), np.float32)
    return {
        'observation': obs.reshape(B, T, 1, 17, 7, 11),
        'selected_prob': rng.uniform(0.1, 1, (B, T, 1, 1)).astype(
            np.float32),
        'value': rng.uniform(-1, 1, (B, T, 1, 1)).astype(np.float32),
        'action': rng.randint(0, 4, (B, T, 1, 1)).astype(np.int32),
        'outcome': np.sign(rng.randn(B, 1, 1, 1)).astype(np.float32),
        'reward': np.zeros((B, T, 1, 1), np.float32),
        'return': np.zeros((B, T, 1, 1), np.float32),
        'episode_mask': ones, 'turn_mask': ones, 'observation_mask': ones,
        'action_mask': np.zeros((B, T, 1, 4), np.float32),
        'progress': np.linspace(0, 1, T, dtype=np.float32)[None, :, None]
        .repeat(B, 0)}


def former_training(torch, make_env, tmp):
    """15(g): ``Learner(args, net=GeeseFormer())`` in this process on the
    fused loop at the north-star config, FORMER_EPOCHS epochs (K5 in
    training, no trunk kernel); then one graphed VTRACE step (B, T =
    FORMER_STEP) on the card held to the CPU step (phase 4's tolerances;
    fp32, TF32 off), its replays timed by CUDA events."""
    from handyrl_tpu_torch.bench import LR
    from handyrl_tpu_torch.config import apply_defaults
    from handyrl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from handyrl_tpu_torch.ops.losses import LossConfig
    from handyrl_tpu_torch.train import Learner
    raw = json.loads(json.dumps(FUSED_CONFIG))
    raw['env_args'] = {'env': 'HungryGeese'}
    raw['train_args'].update(epochs=FORMER_EPOCHS,
                             checkpoint_interval=FORMER_EPOCHS,
                             model_dir=os.path.join(tmp, 'models'))
    net = former_net(torch, SEED + 156)
    before = {k: v.detach().clone() for k, v in net.state_dict().items()}
    learner = Learner(apply_defaults(raw), net=net, device='cuda')
    reset_kernel_launches()
    t0 = time.monotonic()
    learner.run()
    line = dict(learner.summary(), wall=time.monotonic() - t0)
    if not line.get('fused'):
        fail('15(g): GeeseFormer did not run the fused loop')
    out = check_learner_line('15(g) GeeseFormer fused loop', line,
                             FORMER_EPOCHS, {'training': ('vtrace',)})
    moved = sum(not torch.equal(before[k], learner.params[k].cpu())
                for k in before)
    if moved != len(before):
        fail('15(g): %d of %d params moved' % (moved, len(before)))
    B, T = FORMER_STEP
    batch = former_batch(make_env, B, T, SEED + 157)
    cfg = LossConfig(turn_based_training=False, observation=True,
                     policy_target='VTRACE', value_target='VTRACE',
                     gamma=0.99)

    def make():
        return former_net(torch, SEED + 158)
    old, cpu, _ = stats_steps(torch, make, cfg, batch, 'cpu', (LR,), False)
    reset_kernel_launches()
    _, graphed, step = stats_steps(torch, make, cfg, batch, 'cuda', (LR,),
                                   True)
    torch.cuda.synchronize()
    launches = kernel_launches()
    check_against_cpu('15(g) GeeseFormer VTRACE B=%d T=%d graphed' % (B, T),
                      old, graphed[0], cpu[0], lr=LR)
    if launches['vtrace'] < 1 or any(n for k, n in launches.items()
                                     if k != 'vtrace'):
        fail('15(g): the GeeseFormer step launched %s' % launches)
    dev_batch = to_device_batch(torch, batch, 'cuda')
    lr = torch.tensor(LR, device='cuda')
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FORMER_STEP_REPS):
        step(dev_batch, lr)
    end.record()
    torch.cuda.synchronize()
    out.update(step_launches=launches,
               graphed_ms=start.elapsed_time(end) / FORMER_STEP_REPS)
    log('15(g) GeeseFormer graphed VTRACE step B=%d T=%d (%s): %.3f ms'
        % (B, T, nvidia_smi_line(), out['graphed_ms']))
    return out


def phase_bf16_kernels(torch, geese_trunk, GeeseNet, make_env):
    """Phase 15(a), which main() runs right after phase 2: late in the
    script torch.profiler records no kernel (an H100 run of the whole
    script: an empty profile in 15(a) after phase 14), and K2's two phases
    are timed apart by it. Returns ({n: K1 row}, {n: K2 row}, seconds)."""
    log('== phase 15(a), run after phase 2: the bf16 kernels against their '
        'plain bf16 versions')
    t = time.monotonic()
    fwd, bwd = bf16_kernels(torch, geese_trunk, GeeseNet, make_env)
    return fwd, bwd, time.monotonic() - t


def phase_bf16_former(torch, repo, make_env, kernels):
    """Phase 15: compute_dtype bfloat16 (``kernels``, 15(a)'s result; the
    bench, one step, the fused loop, TicTacToe's host learner), then
    GeeseFormer (served, trained); each part's seconds, one JSON line."""
    from handyrl_tpu_torch.model import fp32_on_card
    t0 = time.monotonic()
    fwd, bwd, seconds_a = kernels
    seconds = {'a': seconds_a}
    tmp = tempfile.mkdtemp(prefix='chip_smoke_bf16_')
    try:
        log('== phase 15(b): the bench entry in bf16')
        t = time.monotonic()
        bench = run_bench_entry(repo, 'bfloat16')
        seconds['b'] = time.monotonic() - t
        log('== phase 15(c): one graphed bf16 step against the CPU')
        t = time.monotonic()
        step = bf16_step(torch, make_env)
        seconds['c'] = time.monotonic() - t
        log('== phase 15(d): the fused loop in bf16')
        t = time.monotonic()
        os.makedirs(os.path.join(tmp, 'fused'))
        fused = bf16_fused(repo, os.path.join(tmp, 'fused'))
        seconds['d'] = time.monotonic() - t
        log('== phase 15(e): TicTacToe\'s host learner in bf16')
        t = time.monotonic()
        ttt = bf16_tictactoe(torch, os.path.join(tmp, 'ttt'))
        fp32_on_card(torch.device('cuda'))
        seconds['e'] = time.monotonic() - t
        log('== phase 15(f): GeeseFormer served from a registry snapshot')
        t = time.monotonic()
        serving = former_serving(torch, repo, make_env)
        seconds['f'] = time.monotonic() - t
        log('== phase 15(g): GeeseFormer trained (fused loop, graphed step)')
        t = time.monotonic()
        former = former_training(torch, make_env, os.path.join(tmp, 'former'))
        seconds['g'] = time.monotonic() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds['total'] = time.monotonic() - t0 + seconds_a
    out = {'phase': 15, 'fwd': {str(n): r for n, r in fwd.items()},
           'bwd': {str(n): {k: v for k, v in r.items()}
                   for n, r in bwd.items()},
           'bench': bench, 'step': step, 'fused': fused, 'tictactoe': ttt,
           'serving': serving, 'former': former, 'seconds': seconds,
           'card': nvidia_smi_line()}
    print(json.dumps(out), flush=True)
    out['fwd'], out['bwd'] = fwd, bwd
    return out


# ------------------ phase 16: the durable training plane, streaming, IMPACT

# (a) the SIGKILL drill: --server on Hungry Geese at full width, VTRACE,
# the IMPACT target and 32-ply streamed chunks, one worker host whose one
# gather is a DeviceActorGather ('device' records stream through its emit
# sink); the learner is SIGKILLed once DURABLE_KILL_EPOCH epochs closed,
# restarted with restart_epoch -1, and finishes DURABLE_EPOCHS (epochs of
# 64 episodes: after two, the geese live about ten times as many plies)
DURABLE_EPOCHS, DURABLE_KILL_EPOCH = 3, 2
DURABLE_STREAMING = {'enabled': True, 'chunk_steps': 32, 'target_clip': 1.0,
                     'target_sync_epochs': 2}
DURABLE_FT = {'heartbeat_interval': 1.0, 'liveness_timeout': 8.0,
              'rpc_timeout': 30.0, 'task_deadline': 60.0,
              'reconnect_initial_delay': 0.25, 'reconnect_max_delay': 1.0,
              'reconnect_max_tries': 240}
DURABLE_TRAIN = {'epochs': DURABLE_EPOCHS, 'restart_epoch': -1,
                 'minimum_episodes': 64, 'update_episodes': 64,
                 'eval_rate': 0.1, 'policy_target': 'VTRACE',
                 'value_target': 'VTRACE', 'generation': DA_GENERATION,
                 'streaming': DURABLE_STREAMING,
                 'fault_tolerance': DURABLE_FT}
# (b) the host-worker stream: tictactoe.json with 2-ply chunks (every game
# streams in several), a worker host of STREAM_WORKERS workers whose gather
# is SIGKILLed mid-stream: after the first epoch closed, once the spool
# holds at least STREAM_OPEN_AT_KILL assemblies with chunks delivered and
# no final chunk (a fixed delay after the close once found every stranded
# task still before its first chunk, the workers loading the new model);
# the host is never quarantined (the drill shows the merge, phase 9(b)
# the quarantine)
STREAM_WORKERS, STREAM_OPEN_AT_KILL = 4, 2
STREAM_TRAIN = {'compress_steps': 2, 'minimum_episodes': 64,
                'update_episodes': 64,
                'streaming': {'enabled': True, 'chunk_steps': 2},
                'fault_tolerance': dict(DURABLE_FT,
                                        host_quarantine_after=1000)}
STREAM_EPOCHS = 2
# (c) the graphed VTRACE step with the target at B=128, T=16 on real
# boards; IMPACT_LAG_STEPS steps of lag at IMPACT_LR (the bench's lr moves
# the target too little to see) held to the CPU's static step at STEP_B
IMPACT_LAG_STEPS, IMPACT_LR = 3, 1e-3
PHASE16_TIMEOUT = 240     # each run's processes


def start_session(cmd, repo, env, logs):
    """``python -m cmd...`` writing to ``logs`` (stdout, stderr) in a
    session of its own."""
    with open(logs[0], 'w') as out, open(logs[1], 'w') as err:
        return subprocess.Popen([sys.executable, '-m'] + cmd, cwd=repo,
                                stdout=out, stderr=err, env=env,
                                start_new_session=True)


def read_text(path):
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ''


def kill_sessions(procs):
    for proc in procs:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait()


def check_durable_training(label, line, kernels_a_step):
    """The restarted learner's launches: ``kernels_a_step`` ({name: per
    step}) in training for each step it ran (the graph's warm-up steps
    included) and nothing outside training."""
    from handyrl_tpu_torch.ops.train_step import GRAPH_WARMUP_STEPS
    by_path = line['kernel_launches']
    runs = line['steps_at_exit'] - line['steps_at_start'] + GRAPH_WARMUP_STEPS
    train = by_path.get('training', {})
    if set(by_path) - {'training'} or any(
            train.get(k, 0) != kernels_a_step.get(k, 0) * runs
            for k in set(train) | set(kernels_a_step)):
        fail('%s launched %s (%s a step of %d steps expected)'
             % (label, by_path, kernels_a_step, runs))
    return runs


def durable_drill(torch, repo):
    """16(a): the SIGKILL drill (DURABLE_*): MTTR from the SIGKILL to the
    restarted trainer's first step; episodes/s and plies/s (of the counted
    episodes) before, between the first learner's last two epoch closes,
    and after, from the restarted trainer's first step to its first epoch
    close (host clock)."""
    import math
    tmp = tempfile.mkdtemp(prefix='chip_smoke_durable_')
    procs = []
    try:
        cfg = json.loads(json.dumps(LEARNER_CONFIG))
        cfg['train_args'].update(json.loads(json.dumps(DURABLE_TRAIN)))
        cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
        metrics = os.path.join(tmp, 'metrics.jsonl')
        cfg['train_args']['metrics_jsonl'] = metrics
        cfg['worker_args'] = {'server_address': '127.0.0.1',
                              'num_parallel': 1, 'backend': 'device'}
        path = os.path.join(tmp, 'config.json')
        with open(path, 'w') as f:
            json.dump(cfg, f)
        entry, data = free_ports(2)
        env = dict(os.environ, PYTHONUNBUFFERED='1',
                   HANDYRL_TPU_ENTRY_PORT=str(entry),
                   HANDYRL_TPU_DATA_PORT=str(data))
        logs = {k: (os.path.join(tmp, k + '.out'),
                    os.path.join(tmp, k + '.err'))
                for k in ('learner1', 'learner2', 'host')}
        learner_cmd = ['handyrl_tpu_torch.train', '--config', path,
                       '--server']
        deadline = time.monotonic() + PHASE16_TIMEOUT
        procs.append(start_session(learner_cmd, repo, env,
                                   logs['learner1']))
        learner1 = procs[-1]
        procs.append(start_session(['handyrl_tpu_torch.worker', '--config',
                                    path], repo, env, logs['host']))
        host = procs[-1]

        def closed_epochs():
            if not os.path.exists(metrics):
                return []
            return [r for r in read_metrics(metrics) if 'preempted' not in r]
        while len(closed_epochs()) < DURABLE_KILL_EPOCH:
            if learner1.poll() is not None or host.poll() is not None \
                    or time.monotonic() > deadline:
                fail('16(a): the first learner did not close %d epochs; '
                     'the learner:\n%s\n%s\nthe host:\n%s' % (
                         DURABLE_KILL_EPOCH, tail(logs['learner1'][0], 20),
                         tail(logs['learner1'][1]), tail(logs['host'][1])))
            time.sleep(0.05)
        # with records in flight: the kill waits for the spool to grow
        # past the epoch's snapshot (a record the restart must replay)
        spool = os.path.join(tmp, 'models', 'spool')

        def spooled():
            return sum(os.path.getsize(os.path.join(spool, n))
                       for n in os.listdir(spool))
        mark = spooled()
        while spooled() == mark and time.monotonic() < deadline:
            time.sleep(0.01)
        learner1.send_signal(signal.SIGKILL)
        t_kill = time.time()
        learner1.wait()
        before = closed_epochs()
        procs.append(start_session(learner_cmd, repo, env, logs['learner2']))
        learner2 = procs[-1]
        for proc in (learner2, host):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail('16(a) did not finish within %d s; the restarted '
                     'learner:\n%s\n%s\nthe host:\n%s\n%s' % (
                         PHASE16_TIMEOUT, tail(logs['learner2'][0], 20),
                         tail(logs['learner2'][1]), tail(logs['host'][0]),
                         tail(logs['host'][1])))
        for k, proc in (('learner2', learner2), ('host', host)):
            if proc.returncode != 0:
                fail('16(a): the %s exited %d:\n%s' % (
                    k, proc.returncode, tail(logs[k][1])))
        out2 = read_text(logs['learner2'][0])
        host_out = read_text(logs['host'][0])
        host_err = read_text(logs['host'][1])
        for l in out2.splitlines():
            if l.startswith(('durable plane', 'auto-resume', 'resumed',
                             'epoch', 'updated model', 'fleet:')):
                log('  16(a) restarted learner: %s' % l)
        line = learner_json('16(a)', out2)
        if 'durable plane: restored ledger book' not in out2:
            fail('16(a): the restarted learner did not restore its ledger '
                 'book:\n%s' % out2[-3000:])
        restored = int(out2.split('returned=')[1].split(')')[0])
        dur, stream, fleet = line['durable'], line['streaming'], \
            line['fleet']
        replayed = dur['recovered_episodes'] + dur['recovered_chunks']
        if not replayed > 0:
            fail('16(a): nothing replayed from the spool: %s' % dur)
        if not ('reattached across a learner restart' in host_err
                and 'worker host: 0 gather respawns' in host_out
                and dur['reattached'] >= 1 and fleet['reattaches'] >= 1):
            fail('16(a): the gather did not reattach without a respawn: %s '
                 '%s\n%s' % (dur, fleet, host_out[-1000:]))
        if line['model_epoch'] != DURABLE_EPOCHS or line['failed'] \
                or not (line['losses'] and all(
                    math.isfinite(v) for v in line['losses'].values())):
            fail('16(a): the restarted learner ended at epoch %s (failed %s '
                 '%s), losses %s' % (line['model_epoch'], line['failed'],
                                     line['failed_reason'], line['losses']))
        sources = stream['episodes']
        if not (stream['reassembled_episodes'] > 0
                and sources['streamed'] == stream['reassembled_episodes']
                and line['episodes'] == restored + sources['whole']
                + sources['streamed']
                and line['repeated_sample_keys'] <= fleet['reissued']):
            fail('16(a): the episodes were not each counted once: %d '
                 'counted, %d restored, %s, %d reassembled, %d repeated '
                 'keys, %d re-issued' % (
                     line['episodes'], restored, sources,
                     stream['reassembled_episodes'],
                     line['repeated_sample_keys'], fleet['reissued']))
        runs = check_durable_training(
            '16(a) restarted learner', line,
            {'geese_trunk': 2, 'geese_trunk_bwd': 1, 'vtrace': 1})
        actor = line['device_actor'][0] if line['device_actor'] else {}
        k1 = (actor.get('launches') or {}).get('geese_trunk', 0)
        if not (actor.get('record_mode') == 'device'
                and actor.get('streamed_chunks', 0) > 0
                and k1 >= actor['chunks'] * DA_CHUNK * DA_SLOTS
                and not actor['none_payloads']):
            fail('16(a): the device actor gather did not stream through '
                 'its chunk graph: %s' % actor)
        rows = read_metrics(metrics)
        after = [r for r in rows if r['epoch'] > DURABLE_KILL_EPOCH]

        if len(before) < 2 or not after or line['first_step_at'] is None:
            fail('16(a): rows before %d, after %d, first step %s' % (
                len(before), len(after), line['first_step_at']))
        # the restarted learner counts from the restored episodes and from
        # 0 plies (a restart restores the count of episodes, not of plies)
        restart = {'episodes': restored, 'episode_steps': 0,
                   'time': line['first_step_at']}

        def rate(a, b, key='episodes'):
            return (b[key] - a[key]) / (b['time'] - a['time'])
        out = {'mttr_s': line['first_step_at'] - t_kill,
               'episodes_per_s_before': rate(before[-2], before[-1]),
               'episodes_per_s_after': rate(restart, after[0]),
               'restored_returned': restored,
               'recovered_episodes': dur['recovered_episodes'],
               'recovered_chunks': dur['recovered_chunks'],
               'recovered_reassembled': dur['recovered_reassembled'],
               'reattached': dur['reattached'],
               'generation': dur['generation'],
               'episodes': line['episodes'], 'sources': sources,
               'reassembled_episodes': stream['reassembled_episodes'],
               'open_assemblies': stream['open_assemblies'],
               'abandoned_assemblies': stream['abandoned_assemblies'],
               'repeated_sample_keys': line['repeated_sample_keys'],
               'reissued': fleet['reissued'],
               'duplicates_dropped': fleet['duplicates_dropped'],
               'streamed_chunks': actor['streamed_chunks'],
               'gather_k1_launches': k1, 'chunks': actor['chunks'],
               'training_runs': runs,
               'plies_per_s_before': rate(before[-2], before[-1],
                                          'episode_steps'),
               'plies_per_s_after': rate(restart, after[0], 'episode_steps'),
               'rows': [{k: r.get(k) for k in (
                   'epoch', 'episodes', 'episode_steps', 'time', 'steps',
                   'sgd_steps_per_sec', 'buffer')} for r in rows],
               'actor': {k: actor.get(k) for k in (
                   'blocks', 'chunks', 'chunk_seconds', 'block_seconds',
                   'fill_ratio', 'deferred', 'host_failures', 'episodes',
                   'results', 'plies', 'builds', 'graph_captures')},
               'trainer_batch_wait_seconds':
                   line['trainer_batch_wait_seconds'],
               'trainer_seconds': line['trainer_seconds'],
               'loop_seconds': line['loop_seconds'],
               'dynamics': {k: v for r in after[-1:] for k, v in r.items()
                            if k.startswith('target_')},
               'kernel_launches': line['kernel_launches'],
               'gather_launches': actor['launches']}
        log('16(a) SIGKILL drill, streaming on (%s): %s' % (
            nvidia_smi_line(), json.dumps(out)))
        log('16(a): restored the ledger book, replayed %d spooled record(s) '
            '(%d episode(s) reassembled from them), the gather reattached '
            'with 0 respawns, epoch budget %d complete, %d episodes (%d '
            'restored + %d whole + %d streamed); MTTR %.2f s; episodes/s '
            '%.2f before, %.2f after; plies/s %.1f before, %.1f after' % (
                replayed, dur['recovered_reassembled'], DURABLE_EPOCHS,
                line['episodes'], restored, sources['whole'],
                sources['streamed'], out['mttr_s'],
                out['episodes_per_s_before'], out['episodes_per_s_after'],
                out['plies_per_s_before'], out['plies_per_s_after']))
        left = processes_left(host_err)
        if left:
            fail('16(a): gather processes left after the run: %s' % left)
        return out
    finally:
        kill_sessions(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def open_assemblies(spool):
    """The keys of the streamed episodes whose chunks the learner spooled
    and whose final chunk it has not: the streams in flight."""
    from handyrl_tpu_torch.connection import unpack
    from handyrl_tpu_torch.streaming import chunk_key
    from handyrl_tpu_torch.utils.fs import read_framed_records
    seen, closed = set(), set()
    names = sorted(os.listdir(spool)) if os.path.isdir(spool) else []
    for name in (n for n in names if n.endswith('.wal')):
        records, _, _ = read_framed_records(os.path.join(spool, name))
        for payload in records:
            chunk = unpack(payload).get('chunk')
            if chunk is None:
                continue
            key = chunk_key(chunk)
            seen.add(key)
            if chunk.get('final'):
                closed.add(key)
    return seen - closed


def stream_chaos(torch, repo):
    """16(b): tictactoe.json streaming 2-ply chunks from a worker host of
    STREAM_WORKERS card workers, its gather SIGKILLed mid-stream: the
    stranded tasks re-issue under their sample_keys and their regenerated
    chunks merge (screened as duplicates), no episode counted twice."""
    from handyrl_tpu_torch.ops.train_step import GRAPH_WARMUP_STEPS
    tmp = tempfile.mkdtemp(prefix='chip_smoke_stream_')
    procs = []
    try:
        cfg = quick_config(repo, dict(json.loads(json.dumps(STREAM_TRAIN)),
                                      model_dir=os.path.join(tmp, 'models')),
                           STREAM_EPOCHS)
        cfg['worker_args'] = {'server_address': '127.0.0.1',
                              'num_parallel': STREAM_WORKERS}
        path = os.path.join(tmp, 'config.json')
        with open(path, 'w') as f:
            json.dump(cfg, f)
        entry, data = free_ports(2)
        env = dict(os.environ, PYTHONUNBUFFERED='1',
                   HANDYRL_TPU_ENTRY_PORT=str(entry),
                   HANDYRL_TPU_DATA_PORT=str(data))
        logs = {k: (os.path.join(tmp, k + '.out'),
                    os.path.join(tmp, k + '.err'))
                for k in ('server', 'host')}
        t0 = time.monotonic()
        procs.append(start_session(['handyrl_tpu_torch.train', '--config',
                                    path, '--server'], repo, env,
                                   logs['server']))
        procs.append(start_session(['handyrl_tpu_torch.worker', '--config',
                                    path], repo, env, logs['host']))
        deadline = time.monotonic() + PHASE16_TIMEOUT
        import re
        while 'updated model' not in read_text(logs['server'][0]):
            if any(p.poll() is not None for p in procs) \
                    or time.monotonic() > deadline:
                fail('16(b): the first epoch did not close:\n%s\n%s' % (
                    tail(logs['server'][1]), tail(logs['host'][1])))
            time.sleep(0.02)
        spool = os.path.join(tmp, 'models', 'spool')
        while len(open_assemblies(spool)) < STREAM_OPEN_AT_KILL:
            if any(p.poll() is not None for p in procs) \
                    or time.monotonic() > deadline:
                fail('16(b): no %d streams in flight after the first epoch'
                     % STREAM_OPEN_AT_KILL)
            time.sleep(0.01)
        gather = int(re.findall(r'started gather 0 \(pid (\d+)\)',
                                read_text(logs['host'][1]))[0])
        os.kill(gather, signal.SIGKILL)
        log('16(b): SIGKILLed gather 0 (pid %d) mid-stream' % gather)
        for proc in procs[::-1]:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail('16(b) did not finish within %d s; the server:\n%s\n%s'
                     '\nthe worker host:\n%s\n%s' % (
                         PHASE16_TIMEOUT, tail(logs['server'][0], 20),
                         tail(logs['server'][1]), tail(logs['host'][0]),
                         tail(logs['host'][1])))
        wall = time.monotonic() - t0
        for k, proc in zip(('server', 'host'), procs):
            if proc.returncode != 0:
                fail('16(b): the %s exited %d:\n%s' % (
                    k, proc.returncode, tail(logs[k][1])))
        line = learner_json('16(b)', read_text(logs['server'][0]))
        host_out = read_text(logs['host'][0])
        if 'worker host: 1 gather respawns' not in host_out:
            fail('16(b): the gather was not killed and respawned:\n%s'
                 % host_out[-2000:])
        fleet, stream = line['fleet'], line['streaming']
        if line['epochs'] != STREAM_EPOCHS or line['failed'] \
                or line['fleet_failure']:
            fail('16(b) trained %s epochs (%s %s)' % (
                line['epochs'], line['failed_reason'], line['fleet_failure']))
        if not (fleet['reissued'] > 0 and fleet['duplicates_dropped'] > 0
                and stream['reassembled_episodes'] > 0
                and line['repeated_sample_keys'] == 0
                and stream['episodes']['whole'] == 0
                and line['distinct_sample_keys'] == line['episodes']
                == stream['reassembled_episodes']):
            fail('16(b): the re-issued streams did not merge once: %s %s, '
                 '%d episodes, %d distinct keys, %d repeated' % (
                     fleet, stream, line['episodes'],
                     line['distinct_sample_keys'],
                     line['repeated_sample_keys']))
        by_path = line['kernel_launches']
        runs = line['steps_at_exit'] + GRAPH_WARMUP_STEPS
        if set(by_path) - {'training'} or {
                k: n for k, n in by_path.get('training', {}).items()
                if n} != {'td_lambda': runs}:
            fail('16(b) launched %s (K3 once a step of %d expected)'
                 % (by_path, runs))
        out = {'episodes': line['episodes'], 'epochs': line['epochs'],
               'reassembled_episodes': stream['reassembled_episodes'],
               'reissued': fleet['reissued'],
               'duplicates_dropped': fleet['duplicates_dropped'],
               'outstanding': fleet['outstanding'],
               'episodes_per_s': line['episodes_per_s'], 'wall': wall,
               'kernel_launches': by_path}
        log('16(b) host-worker stream, a gather killed (%s): %s' % (
            nvidia_smi_line(), json.dumps(out)))
        left = processes_left(read_text(logs['host'][1]))
        if left:
            fail('16(b): worker or gather processes left: %s' % left)
        return out
    finally:
        kill_sessions(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def impact_step(torch, make_env):
    """16(c): the graphed VTRACE step with the IMPACT target at B=128,
    T=16 on real boards beside the same step without it: a fresh target at
    clip 1.0 gives the no-target loss terms (the target's forward is K1's
    serving form, the live one its training form: the same math in other
    kernels, so within STEP_RTOL, the log says by how much); K1 twice
    and K2 and K5 once a step; both timed by CUDA events and the host
    clock; a sync is a copy_ into the graph's buffers (no capture); then
    IMPACT_LAG_STEPS lagged steps at STEP_B against the CPU's."""
    import numpy as np
    from handyrl_tpu_torch import bench
    from handyrl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    from handyrl_tpu_torch.ops.train_step import (StaticUpdateStep,
                                                  build_graphed_update_step)
    obs = np.stack(game_observations(make_env, 128 * 16, SEED + 161))
    obs = obs.reshape(128, 16, 1, 17, 7, 11)

    def setup(device, B, target):
        net, cfg, batch, state = bench.headline_setup(
            device, B=B, policy_target='VTRACE', value_target='VTRACE')
        batch['observation'] = torch.from_numpy(obs[:B]).to(device)
        if target:
            cfg = cfg._replace(target_clip=1.0)
        return net, cfg, batch, state

    steps = {}
    for name, target in (('target', True), ('none', False)):
        net, cfg, batch, state = setup('cuda', 128, target)
        steps[name] = (build_graphed_update_step(net, cfg, state), batch)
    lr = torch.tensor(bench.LR, device='cuda')
    first = {name: {k: float(v) for k, v in step(batch, lr).items()}
             for name, (step, batch) in steps.items()}
    scale = max(abs(first['none']['total']), abs(first['none']['v']), 1.0)
    fresh = {k: abs(first['target'][k] - first['none'][k]) / scale
             for k in ('total', 'p', 'v', 'ent')}
    if not all(e <= STEP_RTOL for e in fresh.values()) or \
            abs(first['target']['diag_target_gap_sum']) > 1e-3:
        fail('16(c): a fresh target at clip 1.0 gives other loss terms than '
             'no target: %s (tol %.0e), gap %s' % (
                 fresh, STEP_RTOL, first['target']['diag_target_gap_sum']))
    exact = all(first['target'][k] == first['none'][k]
                for k in ('total', 'p', 'v', 'ent'))
    # the launches of REPS replays with the target (counts 0 just before)
    REPS = 5
    step_t, batch_t = steps['target']
    torch.cuda.synchronize()
    reset_kernel_launches()
    for _ in range(REPS):
        step_t(batch_t, lr)
    torch.cuda.synchronize()
    launches = kernel_launches()
    want = {'geese_trunk': 2 * REPS, 'geese_trunk_bwd': REPS,
            'vtrace': REPS}
    if {k: n for k, n in launches.items() if n} != want:
        fail('16(c): %d graphed steps with the target launched %s (%s '
             'expected)' % (REPS, launches, want))
    timing = {}
    for name in ('target', 'none', 'none', 'target'):
        step, batch = steps[name]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(G_STEP_REPS):
            step(batch, lr)
        end.record()
        torch.cuda.synchronize()
        timing.setdefault(name, []).append(
            (start.elapsed_time(end) / G_STEP_REPS,
             (time.perf_counter() - t0) * 1e3 / G_STEP_REPS))
    ms = {name: {'event_ms': min(t[0] for t in v),
                 'host_ms': min(t[1] for t in v)}
          for name, v in timing.items()}
    # a sync: copy_ into the buffers the graph reads, no new capture
    ptrs = {k: t.data_ptr() for k, t in step_t.target.items()}
    before = step_t(batch_t, lr)
    gap_lagged = float(before['diag_target_gap_sum'])
    captures = step_t.captures
    step_t.sync_target()
    synced = {k: float(v) for k, v in step_t(batch_t, lr).items()}
    if step_t.captures != captures or captures != 1 or any(
            t.data_ptr() != ptrs[k] for k, t in step_t.target.items()):
        fail('16(c): the sync recaptured the graph or moved its buffers '
             '(captures %d -> %d)' % (captures, step_t.captures))
    if not abs(synced['diag_target_gap_sum']) < abs(gap_lagged):
        fail('16(c): after the sync the replay still reads the old target '
             '(gap %s before, %s after)' % (gap_lagged,
                                            synced['diag_target_gap_sum']))
    # lagged steps on the card against the CPU (STEP_B boards)
    lag = {}
    for device in ('cuda', 'cpu'):
        net, cfg, batch, state = setup(device, STEP_B, True)
        cls = build_graphed_update_step if device == 'cuda' \
            else StaticUpdateStep
        step = cls(net, cfg, state)
        lr_lag = torch.tensor(IMPACT_LR, device=device)
        for _ in range(IMPACT_LAG_STEPS):
            m = step(batch, lr_lag)
        lag[device] = ({k: float(v) for k, v in m.items()},
                       {k: v.detach().cpu() for k, v in
                        step.state.params.items()})
    (cm, cp), (hm, hp) = lag['cuda'], lag['cpu']
    scale = max(abs(hm['total']), abs(hm['v']), 1.0)
    errs = {k: abs(cm[k] - hm[k]) / scale for k in ('total', 'p', 'v', 'ent')}
    errs.update({k: abs(cm[k] - hm[k]) / max(hm['data_count'], 1.0)
                 for k in ('diag_target_ratio_sum', 'diag_target_gap_sum')})
    params_err = max((cp[k] - hp[k]).abs().max().item() for k in cp)
    if not (all(e <= STEP_RTOL for e in errs.values())
            and params_err <= 2 * IMPACT_LR * IMPACT_LAG_STEPS
            and abs(cm['diag_target_clip'] - hm['diag_target_clip'])
            <= 0.01 * hm['data_count'] and hm['diag_target_gap_sum'] != 0):
        fail('16(c): %d lagged steps on the card disagree with the CPU: %s '
             '(tol %.0e), params %.3g (tol %.0e), target clip %s/%s' % (
                 IMPACT_LAG_STEPS, errs, STEP_RTOL, params_err,
                 2 * IMPACT_LR * IMPACT_LAG_STEPS, cm['diag_target_clip'],
                 hm['diag_target_clip']))
    out = {'fresh_rel_diff': fresh, 'fresh_exact': exact, 'ms': ms,
           'target_over_none': ms['target']['event_ms']
           / ms['none']['event_ms'],
           'launches': launches, 'reps': REPS, 'captures': step_t.captures,
           'syncs': step_t.target_syncs, 'gap_lagged': gap_lagged,
           'gap_synced': synced['diag_target_gap_sum'],
           'lag_vs_cpu': errs, 'lag_params_max_abs_diff': params_err,
           'lag_target_clip': [cm['diag_target_clip'],
                               hm['diag_target_clip']]}
    log('16(c) IMPACT step B=128 T=16 (%s): %s' % (nvidia_smi_line(),
                                                   json.dumps(out)))
    return out


def phase_durable(torch, repo, make_env):
    """Phase 16: (a)-(c), one JSON line."""
    out = {}

    def timed(part, fn):
        t0 = time.monotonic()
        out[part] = fn()
        out[part]['seconds'] = time.monotonic() - t0
    log('== phase 16(c) the graphed IMPACT step')
    timed('impact', lambda: impact_step(torch, make_env))
    # (a) and (b) at once: each waits on processes of its own
    log('== phase 16(a) the SIGKILL drill, streaming on, and (b) the '
        'host-worker stream, a gather killed, at once')
    concurrently(lambda: timed('drill', lambda: durable_drill(torch, repo)),
                 lambda: timed('stream', lambda: stream_chaos(torch, repo)))
    out['card'] = nvidia_smi_line()
    print(json.dumps({'phase16': {k: {kk: vv for kk, vv in v.items()
                                      if 'launches' not in kk}
                                  if isinstance(v, dict) else v
                                  for k, v in out.items()}}), flush=True)
    return out



# phase 17: the league on the worker plane and the device actor. A
# --server learner on Hungry Geese at full width (VTRACE) fed by one
# DeviceActorGather, publishing every epoch to the registry line
# LEAGUE_LINE, the league's PFSP pool over it, rating matches against the
# members and both anchors, and a gate at margin 0 after 8 games
LEAGUE_LINE = 'geese'
LEAGUE_EPOCHS = 5
LEAGUE = {'enabled': True, 'anchors': ['random', 'rulebase'],
          'self_play_rate': 0.5, 'rating_match_rate': 0.25, 'min_games': 8,
          'promote_margin': 0.0}
LEAGUE_TRAIN = {'epochs': LEAGUE_EPOCHS, 'minimum_episodes': 64,
                'update_episodes': 64, 'eval_rate': 0.1,
                'policy_target': 'VTRACE', 'value_target': 'VTRACE',
                'generation': DA_GENERATION,
                'serving': {'publish': True, 'line': LEAGUE_LINE},
                'league': LEAGUE}
SERVE_DEFAULT_PORT = 9997  # the service's default (config.SERVING_DEFAULTS)
PHASE17_TIMEOUT = 180      # the learner and its worker host


def league_gates(line, league_mod):
    """Each epoch sync's verdict against ``should_promote`` recomputed on
    the book as it stood (the state the journal would hold), and the
    promotions they add up to."""
    out = []
    for d in line['league']['decisions']:
        book = league_mod.RatingBook()
        book.from_state(d['state'])
        pool = league_mod.LeaguePool(LEAGUE, LEAGUE_LINE)
        pool.champion = d['champion']
        out.append({'epoch': d['epoch'], 'champion': d['champion'],
                    'promoted': d['promoted'],
                    'recomputed': pool.should_promote(book),
                    'learner': book.rating(league_mod.LEARNER),
                    'incumbent': (book.rating(d['champion'])
                                  if d['champion'] else None),
                    'games_since_promote': book.games_since_promote})
    return out


def league_service(repo, cfg, path, tmp):
    """F6 on the card: ``python -m handyrl_tpu_torch --serve --config`` on
    the phase's config (no --device: the card), started beside the
    learner (its start-up overlaps the run; it reads the registry at each
    request). Returns the process and the config file it read."""
    serve_path = path
    if not port_free(SERVE_DEFAULT_PORT):
        # the learner refuses the service's keys in its serving block, so
        # a taken default port is worked around in a copy of the config
        serve_path = os.path.join(tmp, 'serve_config.json')
        cfg = json.loads(json.dumps(cfg))
        cfg['train_args']['serving']['port'] = 0
        with open(serve_path, 'w') as f:
            json.dump(cfg, f)
        log('17: port %d taken; --serve reads a copy of the config with '
            'serving.port 0' % SERVE_DEFAULT_PORT)
    with open(os.path.join(tmp, 'serve.err'), 'w') as err:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'handyrl_tpu_torch', '--serve',
             '--config', serve_path], cwd=repo, stdout=subprocess.PIPE,
            stderr=err, start_new_session=True)
    return proc, serve_path


def league_serve(make_env, proc, serve_path, model_dir, champion):
    """The service answers one INFER for the line's champion, the version
    the gate left, from the learner's model_dir (F6), within SERVE_TOL of
    that checkpoint's forward in this process; SIGTERM exits 75."""
    import numpy as np
    from handyrl_tpu_torch import evaluation
    from handyrl_tpu_torch.serving.client import ServiceClient
    ready = read_ready_line(proc, timeout=120)
    if os.path.abspath(ready['registry']) != os.path.abspath(model_dir) \
            or ready['device'] != 'cuda':
        fail('17: --serve serves %s on %s, not the learner\'s registry %s '
             'on the card (F6)' % (ready['registry'], ready['device'],
                                   model_dir))
    client = ServiceClient('127.0.0.1', ready['port'], timeout=120)
    try:
        spec = '%s@champion' % LEAGUE_LINE
        resolved = client.resolve(spec)
        if str(resolved.get('version')) != str(champion):
            fail('17: the service resolves %s to %s, the manifest\'s '
                 'champion is %s' % (spec, resolved, champion))
        obs = game_observations(make_env, 1, SEED)[0]
        t0 = time.monotonic()
        reply = client.request(spec, obs)
        infer_s = time.monotonic() - t0
        launches = client.status()['kernel_launches']
    finally:
        client.close()
    env = make_env(GEESE_ENV)
    local = evaluation.load_model(
        os.path.join(model_dir, '%s.ckpt' % champion), env, 'cuda')
    want = local.inference(obs)
    err = max(float(np.abs(np.asarray(reply['outputs'][k]) - want[k]).max())
              for k in ('policy', 'value'))
    if not err <= SERVE_TOL or not launches.get('geese_trunk', 0) > 0:
        fail('17: the served champion is %.3g off its checkpoint (tol %.0e); '
             'service launches %s' % (err, SERVE_TOL, launches))
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=60)
    proc.stdout.close()
    if rc != 75:
        fail('17: the service exited %d after SIGTERM (75 expected)' % rc)
    return {'registry': ready['registry'], 'champion': str(champion),
            'config': os.path.basename(serve_path), 'infer_s': infer_s,
            'max_abs_err': err, 'launches': launches}


def phase_league(torch, repo, make_env):
    """Phase 17: the league (LEAGUE_*), one JSON line; F6's service on
    the phase's config, started beside it, answers for the champion."""
    from handyrl_tpu_torch import league as league_mod
    from handyrl_tpu_torch.serving.registry import ModelRegistry
    tmp = tempfile.mkdtemp(prefix='chip_smoke_league_')
    procs = []
    try:
        cfg = json.loads(json.dumps(LEARNER_CONFIG))
        cfg['train_args'].update(json.loads(json.dumps(LEAGUE_TRAIN)))
        model_dir = os.path.join(tmp, 'models')
        cfg['train_args']['model_dir'] = model_dir
        metrics = os.path.join(tmp, 'metrics.jsonl')
        cfg['train_args']['metrics_jsonl'] = metrics
        cfg['worker_args'] = {'server_address': '127.0.0.1',
                              'num_parallel': 1, 'backend': 'device'}
        path = os.path.join(tmp, 'config.json')
        with open(path, 'w') as f:
            json.dump(cfg, f)
        entry, data = free_ports(2)
        env = dict(os.environ, PYTHONUNBUFFERED='1',
                   HANDYRL_TPU_ENTRY_PORT=str(entry),
                   HANDYRL_TPU_DATA_PORT=str(data))
        logs = {k: (os.path.join(tmp, k + '.out'),
                    os.path.join(tmp, k + '.err'))
                for k in ('learner', 'host')}
        t0 = time.monotonic()
        procs.append(start_session(['handyrl_tpu_torch.train', '--config',
                                    path, '--server'], repo, env,
                                   logs['learner']))
        procs.append(start_session(['handyrl_tpu_torch.worker', '--config',
                                    path], repo, env, logs['host']))
        service, serve_path = league_service(repo, cfg, path, tmp)
        procs.append(service)
        deadline = time.monotonic() + PHASE17_TIMEOUT
        for k, proc in zip(('learner', 'host'), list(procs)):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail('17 did not finish within %d s; the learner:\n%s\n%s\n'
                     'the host:\n%s\n%s' % (
                         PHASE17_TIMEOUT, tail(logs['learner'][0], 20),
                         tail(logs['learner'][1]), tail(logs['host'][0]),
                         tail(logs['host'][1])))
            if proc.returncode != 0:
                fail('17: the %s exited %d:\n%s' % (k, proc.returncode,
                                                    tail(logs[k][1])))
        wall = time.monotonic() - t0
        out_text = read_text(logs['learner'][0])
        for l in out_text.splitlines():
            if l.startswith('league:'):
                log('  17 learner: %s' % l)
        line = learner_json('17', out_text)
        actor = da_check_line('17', line, LEAGUE_EPOCHS,
                              ('geese_trunk', 'geese_trunk_bwd', 'vtrace'))
        k1 = actor['launches'].get('geese_trunk', 0)
        if not k1 >= actor['chunks'] * DA_CHUNK * DA_SLOTS:
            fail('17: K1 launched %d times in the gather for %d chunks'
                 % (k1, actor['chunks']))
        lg = line['league']
        seated = sorted(m for m in lg['opponents_sampled'] if '@' in m)
        if len(seated) < 2:
            fail('17: %d distinct registry members seated in \'g\' episodes '
                 '(%s; 2 required)' % (len(seated), lg['opponents_sampled']))
        gates = league_gates(line, league_mod)
        if len(gates) != LEAGUE_EPOCHS or any(
                g['promoted'] != g['recomputed'] for g in gates):
            fail('17: the gate\'s decisions differ from should_promote: %s'
                 % gates)
        reg = ModelRegistry(model_dir).describe()[LEAGUE_LINE]
        promoted = sum(g['promoted'] for g in gates)
        if lg['promotions'] != promoted or \
                '%s@%s' % (LEAGUE_LINE, reg['champion']) != lg['champion']:
            fail('17: %d promotions booked, %d decided; the manifest\'s '
                 'champion %s, the pool\'s %s' % (
                     lg['promotions'], promoted, reg['champion'],
                     lg['champion']))
        rows = [r for r in read_metrics(metrics) if 'league' in r]
        if [r['league']['promotions'] for r in rows] != [
                sum(g['promoted'] for g in gates[:i + 1])
                for i in range(len(rows))]:
            fail('17: the metrics rows\' promotions %s differ from the '
                 'gates %s' % ([r['league']['promotions'] for r in rows],
                               gates))
        journal = lg['journal']
        with open(journal, 'rb') as f:
            raw = f.read()
        book = league_mod.RatingBook()
        if not book.load(journal):
            fail('17: the journal %s does not load' % journal)
        again = os.path.join(tmp, 'journal_again.json')
        book.save(again)
        with open(again, 'rb') as f:
            identical = f.read() == raw
        if not identical:
            fail('17: the journal\'s load + save changed its bytes')
        left = processes_left(read_text(logs['host'][1]))
        if left:
            fail('17: gather processes left after the run: %s' % left)
        served = league_serve(make_env, service, serve_path, model_dir,
                              reg['champion'])
        out = {'card': nvidia_smi_line(), 'wall': wall,
               'episodes': line['episodes'],
               'episodes_per_s': line['episodes_per_s'],
               'members_seated': seated,
               'opponents_sampled': lg['opponents_sampled'],
               'rating_matches': lg['rating_matches'],
               'games': lg['games'], 'ratings': lg['ratings'],
               'promotions': lg['promotions'],
               'champion': reg['champion'], 'versions': sorted(
                   reg['versions'], key=int),
               'gates': gates, 'journal_bytes': len(raw),
               'journal_round_trip_identical': identical,
               'device_actor': {k: actor.get(k) for k in (
                   'blocks', 'episodes', 'results', 'deferred', 'chunks',
                   'fill_ratio', 'chunk_seconds', 'block_seconds',
                   'host_failures', 'record_mode')},
               'serve': {k: v for k, v in served.items()
                         if k != 'launches'},
               'kernel_launches': line['kernel_launches'],
               'gather_launches': actor['launches'],
               'service_launches': served['launches']}
        print(json.dumps({'phase17': {k: v for k, v in out.items()
                                      if 'launches' not in k}}), flush=True)
        log('17: launches by kernel: learner %s, its gather %s, the '
            'service %s' % (line['kernel_launches'], actor['launches'],
                            served['launches']))
        return out
    finally:
        kill_sessions(procs)
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------- phase 18: the host inference engine

PHASE18_TIMEOUT = 180      # each learner run (and the service beside it)
# (a) phase 9(a)'s config with the per-host engine: 8 workers in one gather
# hold no params; the gather's engine coalesces their plies (up to 8 x 4
# seats a tick) into one forward on the card
ENGINE_TRAIN = dict(WORKERS_LOCAL, worker={'num_parallel': 8},
                    inference={'enabled': True})
# (b) engine ticks of these many rows against model_act at the 8-row bucket
ENGINE_BUCKETS = (32, 64)
# (c) (a)'s config cut to 4 workers (8) and 64 episodes an epoch (depth),
# the engine killed once by the chaos clock at its first tick 6.0 s after
# the gather spawned it (seed 0's first draw: 0.29977 x 20), when the
# workers start to play or soon after; re-promoted, they play epoch 1's
# net on the restarted engine
ENGINE_CHAOS_TRAIN = dict(ENGINE_TRAIN, worker={'num_parallel': 4},
                          minimum_episodes=64, update_episodes=64)
ENGINE_CHAOS = 'enginekill=20,engine_max_faults=1,seed=0'
# (d) the remote-service mode: 4 workers (cut from 8) dial --serve on the
# same config through serving.endpoint, 64 episodes an epoch (depth).
# The service resolves '<line>@<mid>' in the learner's registry, which
# holds no epoch 0: the workers fail over at their first request, as the
# JAX workers do, and a fast re-probe re-promotes them once epoch 1 is
# published
ENGINE_REMOTE_TRAIN = dict(
    WORKERS_LOCAL, worker={'num_parallel': 4}, minimum_episodes=64,
    update_episodes=64,
    inference={'enabled': True, 'reprobe_initial_delay': 0.5,
               'reprobe_max_delay': 2.0},
    serving={'publish': True})


def check_engine_workers(label, line, until_failover=True):
    """Every worker of an engine-mode run: its client's counts in its
    beacon, and no launch of a worker that never failed over."""
    stats = line['worker_stats']
    for key, st in stats.items():
        client = st.get('engine_client')
        if client is None:
            fail('%s: worker %s beaconed no engine client' % (label, key))
        launched = sum((st.get('launches') or {}).values())
        if launched and (not until_failover or not client['failovers']):
            fail('%s: worker %s launched %s with %d failovers'
                 % (label, key, st.get('launches'), client['failovers']))
    return stats


def engine_run(repo, tmp, extra, label, chaos=None):
    """The learner's CLI (no --device) on a worker-plane config, in a
    session of its own; its JSON line, stdout and stderr."""
    path = worker_plane_config(tmp, extra)
    env = dict(os.environ, PYTHONUNBUFFERED='1')
    if chaos:
        env['HANDYRL_TPU_CHAOS'] = chaos
    logs = (os.path.join(tmp, 'learner.out'), os.path.join(tmp,
                                                           'learner.err'))
    t0 = time.monotonic()
    proc = start_session(['handyrl_tpu_torch.train', '--config', path],
                         repo, env, logs)
    try:
        proc.wait(timeout=PHASE18_TIMEOUT)
    except subprocess.TimeoutExpired:
        kill_sessions([proc])
        fail('%s did not finish within %d s:\n%s' % (
            label, PHASE18_TIMEOUT, tail(logs[1])))
    wall = time.monotonic() - t0
    out, err = read_text(logs[0]), read_text(logs[1])
    if proc.returncode != 0:
        fail('%s exited %d:\n%s' % (label, proc.returncode, err[-4000:]))
    line = learner_json(label, out)
    line['wall'] = wall
    left = processes_left(err)
    if left:
        fail('%s left worker or gather processes: %s' % (label, left))
    return line, out, err, path


def plies_of(line):
    stats = line['worker_stats'].values()
    return (sum(s.get('plies', 0) for s in stats),
            sum(s.get('random_plies', 0) for s in stats))


def engine_local(repo, workers_local):
    """18(a): the engine path through the learner's CLI."""
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    tmp = tempfile.mkdtemp(prefix='chip_smoke_engine_')
    try:
        label = '18(a) the engine path'
        line, out, _err, _ = engine_run(repo, tmp, ENGINE_TRAIN, label)
        for l in out.splitlines():
            if l.startswith(('epoch', 'loss', 'updated model', 'fleet:')):
                log('  18(a): %s' % l)
        check_worker_plane_line(label, line, ENGINE_TRAIN['epochs'],
                                workers_k1=False)
        models = os.path.join(tmp, 'models')
        for name in ['%d.ckpt' % e for e in
                     range(1, ENGINE_TRAIN['epochs'] + 1)] + [
                'latest.ckpt', 'trainer_state.ckpt']:
            ok, reason = verify_checkpoint(os.path.join(models, name))
            if not ok or reason != 'ok':
                fail('%s: checkpoint %s: %s' % (label, name, reason))
        if line['worker_processes'] != ENGINE_TRAIN['worker']['num_parallel']:
            fail('%s heard from %d worker processes' % (
                label, line['worker_processes']))
        if len(line['engines']) != 1:
            fail('%s: %d engines beaconed (one gather, one engine '
                 'expected)' % (label, len(line['engines'])))
        eng = line['engines'][0]
        k1 = eng['launches'].get('geese_trunk', 0)
        if not k1 > 0 or any(n for k, n in eng['launches'].items()
                             if k != 'geese_trunk'):
            fail('%s: the gather launched %s (K1\'s serving form and '
                 'nothing else expected)' % (label, eng['launches']))
        forwards = sum(eng['buckets'].values())
        if not eng['fill_ratio'] > 1.0 or not k1 >= forwards > 0 or \
                eng['restarts'] or eng['device'] != 'cuda':
            fail('%s: the engine ran %s' % (label, eng))
        stats = check_engine_workers(label, line, until_failover=False)
        if line['engine_clients'].get('failovers') or \
                line['engine_clients'].get('local_inferences'):
            fail('%s: workers failed over with a live engine: %s'
                 % (label, line['engine_clients']))
        net, rand = plies_of(line)
        local_net, local_rand = plies_of(workers_local)
        out = {'card': nvidia_smi_line(), 'wall': line['wall'],
               'workers': len(stats), 'episodes': line['episodes'],
               'episodes_per_s': line['episodes_per_s'],
               'plies_per_s': (net + rand) / line['wall'],
               'net_plies': net, 'random_plies': rand,
               'requests': eng['requests'], 'batches': eng['batches'],
               'fill_ratio': eng['fill_ratio'], 'buckets': eng['buckets'],
               'forwards': forwards, 'k1_launches': k1,
               'k1_per_net_ply': k1 / max(1, net),
               'requests_per_net_ply': eng['requests'] / max(1, net),
               'clients': line['engine_clients'],
               'phase9a': {'workers': len(workers_local['worker_stats']),
                           'episodes_per_s': workers_local['episodes_per_s'],
                           'plies_per_s': (local_net + local_rand)
                           / workers_local['wall'],
                           'k1_launches': workers_local[
                               'worker_kernel_launches']['geese_trunk'],
                           'k1_per_net_ply': workers_local[
                               'worker_kernel_launches']['geese_trunk']
                           / max(1, local_net)},
               'kernel_launches': line['kernel_launches'],
               'gather_launches': eng['launches'],
               'worker_kernel_launches': line['worker_kernel_launches']}
        log('18(a): %d requests in %d batches (%.2f rows a batch), buckets '
            '%s; K1 %d launches in the gather, %.3f a net-played ply (%d '
            'net plies; evaluation forwards included), the workers 0' % (
                eng['requests'], eng['batches'], eng['fill_ratio'],
                eng['buckets'], k1, out['k1_per_net_ply'], net))
        log('18(a): %s' % worker_ply_line(line))
        log('18(a) engine (8 workers) vs 9(a) per-worker (%d workers), same '
            'card (%s): episodes/s %.3f vs %.3f; plies/s %.1f vs %.1f; K1 '
            'a net ply %.3f vs %.3f' % (
                out['phase9a']['workers'], out['card'],
                out['episodes_per_s'], out['phase9a']['episodes_per_s'],
                out['plies_per_s'], out['phase9a']['plies_per_s'],
                out['k1_per_net_ply'], out['phase9a']['k1_per_net_ply']))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def engine_buckets(torch, GeeseNet, make_env):
    """18(b): bucket invariance in this process. The same requests in one
    engine tick of N rows (K1's serving form at N) and one by one through
    model_act (the 8-row bucket) on the full-width net: actions, masks,
    prob and value (and the full-output path's policy) equal bit for bit,
    the largest differences printed; where they differ, the trunk's rows
    and the heads are held apart to say which part does, and it fails."""
    import queue
    import random
    import numpy as np
    from handyrl_tpu_torch import ops
    from handyrl_tpu_torch.generation import (bucketed_inference, model_act,
                                              sample_seed)
    from handyrl_tpu_torch.inference import InferenceEngine
    from handyrl_tpu_torch.model import ModelWrapper, fp32_on_card
    fp32_on_card(torch.device('cuda'))
    gen = torch.Generator().manual_seed(SEED + 18)
    wrapper = ModelWrapper(GeeseNet(
        filters=WIDTH['filters'], layers=WIDTH['layers'],
        torus_impl='pallas', generator=gen), 'cuda')
    snap = wrapper.snapshot()
    n_max = max(ENGINE_BUCKETS)
    obs = game_observations(make_env, n_max, SEED + 18)
    rng = random.Random(SEED)
    legal = [sorted(rng.sample(range(4), rng.randint(1, 4)))
             for _ in range(n_max)]
    seeds = [sample_seed(SEED, (18, n), 0) for n in range(n_max)]
    out = {'card': nvidia_smi_line(), 'by_n': {}}
    launches = {}
    for n in ENGINE_BUCKETS:
        replies = queue.Queue()
        # a tick closes at n rows (max_batch); the deadline never comes
        engine = InferenceEngine(
            {'inference': {'batch_wait_ms': 10000.0, 'max_batch': n},
             'env': GEESE_ENV},
            fetch_snapshot=lambda mid: snap,
            reply_fn=lambda ep, msg: replies.put(msg), example_obs=obs[0],
            clients=n, device='cuda').start()
        try:
            for k in range(n):                # the vault's materialization
                engine.submit(None, {'rid': -1, 'mid': 1, 'obs': obs[k]})
            for k in range(n):
                replies.get(timeout=120)
            ops.reset_kernel_launches()
            t0 = time.monotonic()
            for k in range(n):
                engine.submit(None, {'rid': k, 'mid': 1, 'obs': obs[k],
                                     'hidden': None, 'legal': legal[k],
                                     'seed': seeds[k]})
            acts = {}
            for _ in range(n):
                r = replies.get(timeout=120)
                acts[r['rid']] = r
            tick_s = time.monotonic() - t0
            tick_k1 = ops.kernel_launches()['geese_trunk']
            for k in range(n):
                engine.submit(None, {'rid': k, 'mid': 1, 'obs': obs[k]})
            full = {}
            for _ in range(n):
                r = replies.get(timeout=120)
                full[r['rid']] = r['outputs']
            launches[n] = ops.kernel_launches()
        finally:
            engine.stop()
        if engine.buckets != {n: 3} or tick_k1 != 1:
            fail('18(b): the engine ran buckets %s (K1 %d launches a tick)'
                 % (engine.buckets, tick_k1))
        t0 = time.monotonic()
        local = [model_act(wrapper, obs[k], None, legal[k], seeds[k])
                 for k in range(n)]
        local_s = time.monotonic() - t0
        outs = [bucketed_inference(wrapper, obs[k]) for k in range(n)]
        diffs = {'prob': 0.0, 'value': 0.0, 'policy': 0.0,
                 'full_value': 0.0}
        equal = True
        for k in range(n):
            g, w = acts[k], local[k]
            if g['action'] != w['action'] or not np.array_equal(
                    g['action_mask'], w['action_mask']):
                fail('18(b): row %d of the %d-row tick acts %s, the 8-row '
                     'bucket %s' % (k, n, g['action'], w['action']))
            pairs = (('prob', g['prob'], w['prob']),
                     ('value', g['value'], w['value']),
                     ('policy', full[k]['policy'], outs[k]['policy']),
                     ('full_value', full[k]['value'], outs[k]['value']))
            for key, a, b in pairs:
                a, b = np.asarray(a), np.asarray(b)
                equal &= bool(np.array_equal(a, b))
                diffs[key] = max(diffs[key], float(np.abs(
                    a.astype(np.float64) - b).max()))
        row = {'bitwise': equal, 'max_abs_diff': diffs,
               'tick_ms': tick_s * 1e3, 'one_by_one_ms': local_s * 1e3}
        if not equal:
            # F7 (ROADMAP.md §3), repaired by the heads' row-invariant
            # product (models.blocks.dense): a row's bits at N rows must
            # be its bits at 8, or a failover changes the records
            fail('18(b): the %d-row tick is %s off the 8-row bucket, not '
                 'bit for bit (F7): %s' % (n, diffs, bucket_variance_source(
                     torch, wrapper, obs[:n])))
        out['by_n'][str(n)] = row
        log('18(b) N=%d: bit for bit %s; largest |difference| %s; one tick '
            '%.2f ms vs %d model_act calls %.2f ms (host clock)' % (
                n, equal, {k: '%.3g' % v for k, v in diffs.items()},
                row['tick_ms'], n, row['one_by_one_ms']))
    out['launches'] = launches[max(ENGINE_BUCKETS)]
    out['bitwise'] = all(r['bitwise'] for r in out['by_n'].values())
    return out


def bucket_variance_source(torch, wrapper, obs):
    """Which part of the net gives a row other bits at N rows than at 8:
    the trunk (K1), or the heads (PyTorch's reductions and products)."""
    import numpy as np
    net = wrapper.module
    x = torch.as_tensor(np.stack(obs), device='cuda')
    with torch.no_grad():
        from handyrl_tpu_torch.models.geese import to_nhwc
        xs = to_nhwc(x).float()
        h_n = net.trunk(xs, False)
        h_8 = torch.cat([net.trunk(xs[i:i + 8], False)
                         for i in range(0, len(obs), 8)])
        y_n = net(x)
        y_8 = {k: torch.cat([net(x[i:i + 8])[k]
                             for i in range(0, len(obs), 8)])
               for k in ('policy', 'value')}
    return {'trunk_max_abs_diff': float((h_n - h_8).abs().max()),
            'trunk_bitwise': bool(torch.equal(h_n, h_8)),
            'heads_max_abs_diff': max(float((y_n[k] - y_8[k]).abs().max())
                                      for k in ('policy', 'value'))}


def engine_chaos(repo):
    """18(c): the chaos drill on (a)'s config, cut."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_engine_chaos_')
    try:
        label = '18(c) the engine chaos drill'
        line, _out, err, _ = engine_run(repo, tmp, ENGINE_CHAOS_TRAIN, label,
                                        chaos=ENGINE_CHAOS)
        check_worker_plane_line(label, line, ENGINE_CHAOS_TRAIN['epochs'],
                                workers_k1=None)
        eng = (line['engines'] or [{}])[0]
        clients = line['engine_clients']
        if not eng.get('restarts', 0) >= 1 or \
                not clients.get('failovers', 0) >= 1 or \
                not clients.get('repromotions', 0) >= 1:
            fail('%s: restarts %s, failovers %s, re-promotions %s (each '
                 'at least 1 expected):\n%s' % (
                     label, eng.get('restarts'), clients.get('failovers'),
                     clients.get('repromotions'), err[-3000:]))
        check_engine_workers(label, line)
        out = {'card': nvidia_smi_line(), 'wall': line['wall'],
               'episodes': line['episodes'],
               'restarts_by_reason': eng['restarts_by_reason'],
               'requests': eng['requests'], 'batches': eng['batches'],
               'stale_replies': eng['stale_replies'], 'clients': clients,
               'fleet': line['fleet'],
               'kernel_launches': line['kernel_launches'],
               'gather_launches': eng['launches'],
               'worker_kernel_launches': line['worker_kernel_launches']}
        log('18(c): engine restarts %s; workers: %d failovers, %d '
            're-promotions, %d local inferences, %d timeouts, %d error '
            'replies, %d stale replies; K1 %d launches in the gather, %d in '
            'the workers; %d episodes, each counted once, no task '
            'outstanding; %.1f s' % (
                eng['restarts_by_reason'], clients['failovers'],
                clients['repromotions'], clients['local_inferences'],
                clients['timeouts'], clients['errors'],
                clients['stale_replies'], eng['launches']['geese_trunk'],
                line['worker_kernel_launches']['geese_trunk'],
                line['episodes'], line['wall']))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def engine_remote(repo):
    """18(d): a short learner publishing to its registry, --serve on the
    same config (a copy naming a free port, which the learner's serving
    block refuses), the workers dialing it through serving.endpoint."""
    from handyrl_tpu_torch.serving.client import ServiceClient
    tmp = tempfile.mkdtemp(prefix='chip_smoke_engine_remote_')
    service = None
    try:
        label = '18(d) the remote-service mode'
        port, = free_ports(1)
        extra = json.loads(json.dumps(ENGINE_REMOTE_TRAIN))
        extra['serving']['endpoint'] = 'localhost:%d' % port
        cfg = json.loads(json.dumps(LEARNER_CONFIG))
        cfg['train_args'].update(json.loads(json.dumps(extra)))
        cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
        mport, = free_ports(1)
        cfg['train_args']['serving'].update(port=port, metrics_port=mport)
        serve_path = os.path.join(tmp, 'serve_config.json')
        with open(serve_path, 'w') as f:
            json.dump(cfg, f)
        with open(os.path.join(tmp, 'serve.err'), 'w') as err:
            service = subprocess.Popen(
                [sys.executable, '-m', 'handyrl_tpu_torch', '--serve',
                 '--config', serve_path], cwd=repo, stdout=subprocess.PIPE,
                stderr=err, start_new_session=True)
        ready = read_ready_line(service, timeout=120)
        if ready['port'] != port or ready['device'] != 'cuda':
            fail('%s: the service is ready on %s' % (label, ready))
        line, _out, err, _ = engine_run(repo, tmp, extra, label)
        check_worker_plane_line(label, line, ENGINE_REMOTE_TRAIN['epochs'],
                                workers_k1=None)
        check_engine_workers(label, line)
        clients = line['engine_clients']
        if line['engines'] or not clients.get('remote_dials', 0) >= 1 or \
                not clients.get('repromotions', 0) >= 1:
            fail('%s: local engines %s; clients %s (dials and a '
                 're-promotion expected):\n%s' % (
                     label, line['engines'], clients, err[-3000:]))
        client = ServiceClient('127.0.0.1', port, timeout=60)
        try:
            status = client.status()
        finally:
            client.close()
        if not status['kernel_launches'].get('geese_trunk', 0) > 0 or \
                not status['answered'] > 0:
            fail('%s: the service answered %d requests with launches %s'
                 % (label, status['answered'], status['kernel_launches']))
        if ready['metrics_port'] != mport:
            fail('%s: the exporter is on %s, not %d' % (
                label, ready['metrics_port'], mport))
        text, scrape_ms, statusz = scrape(mport)
        served = sum(prom_values(text, 'serve_requests_total').values())
        if not served > 0 or not (statusz.get('progress') or {}).get(
                'answered', 0) > 0 or 'slo' not in statusz:
            fail('%s: /metrics counts %s requests, /statusz %s' % (
                label, served, statusz))
        status_lines = status_done(label, status_cli(repo, mport))
        service.send_signal(signal.SIGTERM)
        rc = service.wait(timeout=60)
        service.stdout.close()
        if rc != 75:
            fail('%s: the service exited %d after SIGTERM (75 expected)'
                 % (label, rc))
        service = None
        out = {'card': nvidia_smi_line(), 'wall': line['wall'],
               'episodes': line['episodes'], 'clients': clients,
               'service': {k: status[k] for k in (
                   'received', 'answered', 'engine_requests',
                   'engine_batches', 'shed')},
               'exporter': {'scrape_ms': scrape_ms,
                            'lines': len(text.splitlines()),
                            'serve_requests_total': served,
                            'statusz_slo': statusz['slo']},
               'kernel_launches': line['kernel_launches'],
               'service_launches': status['kernel_launches'],
               'worker_kernel_launches': line['worker_kernel_launches']}
        log('18(d): the service answered %d of %d requests in %d batches, '
            'K1 %d launches; workers: %d dials, %d failovers (epoch 0 is not '
            'in the registry), %d re-promotions, %d local inferences, K1 %d '
            'launches after failing over; the service exited 75 on SIGTERM'
            % (status['answered'], status['received'],
               status['engine_batches'],
               status['kernel_launches']['geese_trunk'],
               clients['remote_dials'], clients['failovers'],
               clients['repromotions'], clients['local_inferences'],
               line['worker_kernel_launches']['geese_trunk']))
        log('18(d): the service\'s /metrics scraped in %.2f ms (%d lines, '
            'serve_requests_total %d); /statusz slo %s; --status: %s' % (
                scrape_ms, len(text.splitlines()), served, statusz['slo'],
                ' | '.join(status_lines[:3])))
        return out
    finally:
        if service is not None:
            kill_sessions([service])
        shutil.rmtree(tmp, ignore_errors=True)


def phase_engine(torch, repo, GeeseNet, make_env, workers_local,
                 beside=None):
    """Phase 18: the host inference engine of a gather: (a) alone (it is
    measured against phase 9(a)), (b) in this process, then (c) and (d)
    at once (learner processes of their own) and ``beside`` with them (an
    independent phase's part); returns the phase's results and
    ``beside``'s."""
    t0 = time.monotonic()
    log('== phase 18(a): the engine path (8 workers, one gather)')
    local = engine_local(repo, workers_local)
    log('== phase 18(b): bucket invariance in process')
    buckets = engine_buckets(torch, GeeseNet, make_env)
    log('== phase 18(c)+(d): the chaos drill and the remote-service mode%s'
        % (' (beside phase 17)' if beside else ''))
    chaos, remote, other = concurrently(
        lambda: engine_chaos(repo), lambda: engine_remote(repo),
        beside or (lambda: None))
    out = {'local': local, 'buckets': buckets, 'chaos': chaos,
           'remote': remote, 'seconds': time.monotonic() - t0}
    print(json.dumps({'phase18': {
        k: ({kk: vv for kk, vv in v.items() if 'launches' not in kk}
            if isinstance(v, dict) else v) for k, v in out.items()}}),
        flush=True)
    return out, other


# ------------------------------------------------------- phase 19 (fleet)

LSTM_BUCKETS = (1, 8, 32, 64)   # engine ticks held against model_act at 8
# (a) the serving fleet: 2 managed replicas (the JAX default) heartbeating
# every 0.5 s (the JAX 2 s, cut so that a drain is seen sooner; the JAX
# heartbeat_timeout 10 s stands); a burst of FLEET_BURST requests, all
# steered to the victim, stranded by its SIGKILL; FLEET_LATENCY requests
# one at a time for p50/p99 before and after
FLEET_REPLICAS = 2
FLEET_BURST = 64
FLEET_LATENCY = 64
FLEET_HEARTBEAT = 0.5
# (b) GW_SESSIONS Hungry Geese sessions against default@champion (the
# full-width GeeseNet), (c) GW_LSTM_SESSIONS against lstm@champion (the
# full-width GeeseNetLSTM); each held after GW_HOLD plies, a replica
# SIGKILLed, released once the gateway has rebuilt what it held
GW_SESSIONS = 8
GW_LSTM_SESSIONS = 4
GW_HOLD = 3
# the serving tier's telemetry: every request and session traced, the
# alert engines evaluated every second, each tier's exporter on a free
# port; the gateway process alone runs under the runtime sanitizer
FLEET_TELEMETRY = {'trace_sample_rate': 1.0, 'alerts': {'interval': 1.0}}
# the serving tier's telemetry cost on the warm fleet after (b)'s respawn:
# rounds of GW_SESSIONS clients, AB_MATCHES matches each back to back and
# no kill, in AB_ORDER, each (the gateway it plays on, that gateway traced,
# the replicas traced): a second gateway without the sanitizer, its and
# the replicas' tracing switched off and on by the ``trace`` op, and the
# sanitized gateway, traced
AB_MATCHES = 2
AB_ORDER = (('plain', False, False), ('plain', True, True),
            ('sanitized', True, True), ('sanitized', True, True),
            ('plain', True, True), ('plain', False, False))
AB_ARMS = {(False, False): 'untraced', (True, True): 'traced',
           (True, False): 'gateway_traced', (False, True): 'replicas_traced'}
SERVE_CHAIN = ('client_request', 'route_dispatch', 'serve_request',
               'queue_wait', 'engine_batch')
SANITIZER_LINE = r'graftlint-sanitizer: (\d+) lock-order inversion\(s\), ' \
    r'(\d+) unnamed thread\(s\), (\d+) leaked non-daemon thread\(s\)'


def scrape(port):
    """One ``/metrics`` scrape of an exporter on 127.0.0.1 (its text and
    milliseconds) and its ``/statusz`` payload."""
    import urllib.request
    base = 'http://127.0.0.1:%d' % port
    t0 = time.monotonic()
    text = urllib.request.urlopen(base + '/metrics', timeout=10
                                  ).read().decode()
    ms = 1e3 * (time.monotonic() - t0)
    status = json.loads(urllib.request.urlopen(base + '/statusz',
                                               timeout=10).read())
    return text, ms, status


def status_cli(repo, port):
    """``python -m handyrl_tpu_torch --status 127.0.0.1:PORT``, started;
    :func:`status_done` reads it."""
    return subprocess.Popen(
        [sys.executable, '-m', 'handyrl_tpu_torch', '--status',
         '127.0.0.1:%d' % port], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def status_done(label, proc):
    out, err = proc.communicate(timeout=60)
    if proc.returncode != 0:
        fail('%s: --status exited %d:\n%s%s' % (
            label, proc.returncode, out[-2000:], err[-2000:]))
    return out.splitlines()


def phase_swa(repo, models):
    """``scripts/torch_aux_swa.py TicTacToe 1 QUICK_EPOCHS`` on the quick
    start's checkpoints, on the card in a child process: exit 0, the
    strict reload's probe finite. Returns its seconds and last line."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, os.path.join('scripts', 'torch_aux_swa.py'),
         'TicTacToe', '1', str(QUICK_EPOCHS), models], cwd=repo,
        capture_output=True, text=True, timeout=300)
    seconds = time.monotonic() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or 'finite True' not in lines[-1] \
            or 'device cuda' not in lines[-1] or not os.path.exists(
                os.path.join(models, 'swa.ckpt')):
        fail('SWA: torch_aux_swa.py exited %d:\n%s\n%s' % (
            proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:]))
    log('SWA: torch_aux_swa.py averaged the quick start\'s %d checkpoints '
        'on the card in %.1f s: %s' % (QUICK_EPOCHS, seconds, lines[-1]))
    return {'seconds': seconds, 'line': lines[-1]}


def resolver_checks(fport, names):
    """19 after (a)'s kill and respawn: the resolver's ``/metrics`` (both
    replicas routable, a respawn) and ``/statusz`` (both replicas; the
    ``heartbeat_misses`` alert fired, polled for up to 20 s: the engine
    evaluates every second)."""
    deadline = time.monotonic() + 20
    while True:
        text, ms, status = scrape(fport)
        fired = (status.get('alerts') or {}).get('fired') or {}
        if 'heartbeat_misses' in fired or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    replicas = prom_values(text, 'fleet_replicas').get('', 0)
    respawns = prom_values(text, 'fleet_respawns_total').get('', 0)
    misses = prom_values(text, 'fleet_heartbeat_misses_total').get('', 0)
    disconnects = sum(prom_values(text, 'hub_disconnects_total').values())
    if replicas != FLEET_REPLICAS or respawns < 1 or sorted(
            status.get('fleet_replicas') or {}) != names or \
            'heartbeat_misses' not in fired:
        fail('19(a): the resolver shows fleet_replicas %s, respawns %s, '
             'replicas %s, alerts fired %s' % (
                 replicas, respawns, status.get('fleet_replicas'), fired))
    return {'scrape_ms': ms, 'lines': len(text.splitlines()),
            'fleet_replicas': replicas, 'respawns': respawns,
            'heartbeat_misses_total': misses,
            'hub_disconnects_total': disconnects,
            'alerts_fired': fired, 'requests': status.get('requests')}


def fleet_traces(repo, trace_dir, gateway_pid, resolver_pid, plies):
    """19 after the drain: ``scripts/torch_trace_report.py --serve`` on the
    processes' trace files (exit 0, complete, routed and reconstruct
    chains) and a complete chain whose events come from the gateway's
    process and a replica's."""
    import glob
    rc, report = run_tool(repo, 'torch_trace_report.py',
                          [trace_dir, '--serve'], '19')
    sv = report.get('serve') or {}
    if rc != 0 or not sv.get('complete_chains') or \
            not sv.get('routed_chains') or sv.get('reconstruct_chains', 0) < 1:
        fail('19: torch_trace_report.py --serve exited %d: %s' % (
            rc, {k: sv.get(k) for k in ('chains', 'complete_chains',
                                        'routed_chains',
                                        'reconstruct_chains')}))
    pids = {}
    for path in glob.glob(os.path.join(trace_dir, 'trace-*.jsonl')):
        for line in read_text(path).splitlines():
            try:
                e = json.loads(line)
            except ValueError:
                continue
            a = e.get('args') or {}
            for tid in ([a['trace_id']] if a.get('trace_id') else []) + \
                    list(a.get('trace_ids') or ()):
                pids.setdefault(tid, {}).setdefault(e['name'], set()).add(
                    e.get('pid'))
    across = [t for t, names in pids.items()
              if {'gateway_ply', 'client_request', 'serve_request',
                  'engine_batch'} <= set(names)
              and gateway_pid in names['gateway_ply']
              and names['serve_request'] - {gateway_pid, resolver_pid}]
    if not across:
        fail('19: no traced ply runs from the gateway (pid %d) to a replica'
             % gateway_pid)
    return {'events': report['events'], 'processes': report['processes'],
            'events_per_ply': report['events'] / max(1, plies),
            'chains': sv['chains'], 'complete_chains': sv['complete_chains'],
            'routed_chains': sv['routed_chains'],
            'replay_chains': sv['replay_chains'],
            'reconstruct_chains': sv['reconstruct_chains'],
            'gateway_to_replica_chains': len(across),
            'hop_p50_s': {k: v['p50'] for k, v in sv['hop_seconds'].items()}}


def lstm_buckets(torch, make_env):
    """19(c), first part: GeeseNetLSTM's served rows do not depend on the
    tick they meet. The same requests (real boards, each with a non-zero
    recurrent state from an earlier forward) in one engine tick of N rows
    and one by one through ``model_act`` (the 8-row bucket) on the
    full-width net: action, mask, prob, value and the next (h, c) equal
    bit for bit. The gateway's journal replay meets other sessions' plies
    in other ticks, so a rebuilt session is byte-exact only if this
    holds."""
    import queue
    import random
    import numpy as np
    from handyrl_tpu_torch.generation import model_act, sample_seed
    from handyrl_tpu_torch.inference import InferenceEngine
    from handyrl_tpu_torch.model import ModelWrapper, fp32_on_card
    from handyrl_tpu_torch.utils.tree import map_structure
    fp32_on_card(torch.device('cuda'))
    wrapper = ModelWrapper(lstm_net(torch, SEED + 19), 'cuda')
    snap = wrapper.snapshot()
    n_max = max(LSTM_BUCKETS)
    obs = game_observations(make_env, n_max, SEED + 19)
    # a non-zero state a row: one forward from zeros on another board
    warm = game_observations(make_env, n_max, SEED + 190)
    hidden = [wrapper.inference(warm[k], None)['hidden']
              for k in range(n_max)]
    rng = random.Random(SEED + 19)
    legal = [sorted(rng.sample(range(4), rng.randint(1, 4)))
             for _ in range(n_max)]
    seeds = [sample_seed(SEED, (19, n), 0) for n in range(n_max)]
    local = [model_act(wrapper, obs[k], hidden[k], legal[k], seeds[k])
             for k in range(n_max)]
    out = {'card': nvidia_smi_line(), 'by_n': {}}
    for n in LSTM_BUCKETS:
        replies = queue.Queue()
        engine = InferenceEngine(
            {'inference': {'batch_wait_ms': 10000.0, 'max_batch': n},
             'env': {'env': 'HungryGeese', 'net_kind': 'lstm'}},
            fetch_snapshot=lambda mid: snap,
            reply_fn=lambda ep, msg: replies.put(msg), example_obs=obs[0],
            clients=n, device='cuda').start()
        try:
            for k in range(n):
                engine.submit(None, {'rid': k, 'mid': 1, 'obs': obs[k],
                                     'hidden': hidden[k], 'legal': legal[k],
                                     'seed': seeds[k]})
            got = {}
            for _ in range(n):
                r = replies.get(timeout=120)
                got[r['rid']] = r
        finally:
            engine.stop()
        diffs = {'prob': 0.0, 'value': 0.0, 'hidden': 0.0}
        equal = True
        for k in range(n):
            g, w = got[k], local[k]
            if 'error' in g:
                fail('19(c): the %d-row tick answered %s' % (n, g['error']))
            if g['action'] != w['action'] or not np.array_equal(
                    g['action_mask'], w['action_mask']):
                fail('19(c): row %d of the %d-row tick acts %s, the 8-row '
                     'bucket %s' % (k, n, g['action'], w['action']))
            pairs = [('prob', g['prob'], w['prob']),
                     ('value', g['value'], w['value'])]
            pairs += [('hidden', a, b) for a, b in zip(
                map_structure(np.asarray, list(g['hidden'])),
                map_structure(np.asarray, list(w['hidden'])))]
            for key, a, b in pairs:
                a, b = np.asarray(a), np.asarray(b)
                equal &= bool(np.array_equal(a, b))
                diffs[key] = max(diffs[key], float(np.abs(
                    a.astype(np.float64) - b).max()))
        out['by_n'][str(n)] = {'bitwise': equal, 'max_abs_diff': diffs}
        log('19(c) GeeseNetLSTM N=%d: bit for bit %s; largest |difference| '
            '%s' % (n, equal, {k: '%.3g' % v for k, v in diffs.items()}))
    out['bitwise'] = all(r['bitwise'] for r in out['by_n'].values())
    if not out['bitwise']:
        fail('19(c): GeeseNetLSTM\'s served rows depend on their tick (F8): '
             '%s' % json.dumps(out['by_n']))
    return out


def wait_json_line(path, key, proc, timeout):
    """The JSON line holding ``key`` in a process's stdout file."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for line in read_text(path).splitlines():
            if line.startswith('{') and key in line:
                return json.loads(line)[key]
        if proc.poll() is not None:
            fail('%s: the process exited %s before it was ready'
                 % (key, proc.returncode))
        time.sleep(0.1)
    fail('no %s line within %.0f s' % (key, timeout))


def fleet_requests(make_env, count, seed):
    """(obs, legal, seed sequence) of ``count`` real Geese requests."""
    import random
    from handyrl_tpu_torch.generation import sample_seed
    rng = random.Random(seed)
    obs = game_observations(make_env, count, seed)
    return [(o, sorted(rng.sample(range(4), rng.randint(1, 4))),
             sample_seed(seed, (19, k), 0)) for k, o in enumerate(obs)]


def phase_fleet_prepare(torch, make_env, GeeseNet):
    """Phase 19's part in this process, before the fleet starts: the
    registry (GeeseNet versions 1 and 2 on the 'default' line, the
    GeeseNetLSTM on 'lstm', each full width and seeded), the replies each
    request must get (``model_act`` on the card: a replica's engine runs
    the same bucketed forward, K1 computes each sample alone and F7's
    heads are row invariant, so the bits must be these) and 19(c)'s
    bucket check."""
    from handyrl_tpu_torch.generation import model_act
    from handyrl_tpu_torch.model import ModelWrapper, fp32_on_card
    from handyrl_tpu_torch.serving.registry import ModelRegistry
    fp32_on_card(torch.device('cuda'))
    tmp = tempfile.mkdtemp(prefix='chip_smoke_fleet_')
    root = os.path.join(tmp, 'registry')
    registry = ModelRegistry(root)
    reqs = fleet_requests(make_env, FLEET_BURST, SEED + 191)
    refs = {}
    for version in (1, 2):
        gen = torch.Generator().manual_seed(SEED + 190 + version)
        wrapper = ModelWrapper(GeeseNet(
            filters=WIDTH['filters'], layers=WIDTH['layers'],
            torus_impl='pallas', generator=gen), 'cuda')
        registry.publish('default', snapshot=wrapper.snapshot(),
                         version=version, promote=version == 1)
        refs[version] = [model_act(wrapper, o, None, legal, seed)
                         for o, legal, seed in reqs]
    lstm = ModelWrapper(lstm_net(torch, SEED + 193), 'cpu')
    registry.publish('lstm', snapshot=lstm.snapshot(), version=1,
                     promote=True)
    if all(a['prob'] == b['prob'] for a, b in zip(refs[1], refs[2])):
        fail('19: versions 1 and 2 answer alike; the promote would be void')
    log('== phase 19(c), first part: GeeseNetLSTM\'s rows by tick size')
    buckets = lstm_buckets(torch, make_env)
    return {'tmp': tmp, 'root': root, 'requests': reqs, 'refs': refs,
            'lstm_buckets': buckets}


def same_reply(label, got, want):
    import numpy as np
    if (got['action'] != want['action'] or got['prob'] != want['prob']
            or not np.array_equal(got['action_mask'], want['action_mask'])
            or not np.array_equal(got['value'], want['value'])):
        fail('%s: a routed reply is not the reference\'s bits: %s against '
             '%s' % (label, {k: got[k] for k in ('action', 'prob', 'value')},
                         {k: want[k] for k in ('action', 'prob', 'value')}))


def replica_status(rc):
    """Each routable replica's status reply, by name (the resolver's
    table as it is now, not the router's cached one)."""
    from handyrl_tpu_torch.serving.client import ServiceClient, \
        parse_endpoint
    out = {}
    for row in rc.status()['replicas']:
        if row['state'] not in ('healthy', 'degraded'):
            continue
        client = ServiceClient(*parse_endpoint(row['endpoint']), timeout=60)
        try:
            out[row['replica']] = dict(client.status(), pid=row['pid'])
        finally:
            client.close()
    return out


def latencies_ms(rc, reqs):
    out = []
    for o, legal, seed in reqs:
        t0 = time.perf_counter()
        rc.request('default@champion', o, legal=legal, seed=seed)
        out.append(1e3 * (time.perf_counter() - t0))
    out.sort()
    return {'p50_ms': out[len(out) // 2],
            'p99_ms': out[min(len(out) - 1, int(0.99 * len(out)))]}


def wait_respawn(rc, victim, old_pid, readmitted, deadline_s=180):
    """Seconds until the resolver lists ``victim`` healthy under a new pid
    with one more re-admission (the respawn's re-registration)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        status = rc.status()
        rows = {r['replica']: r for r in status['replicas']}
        row = rows.get(victim)
        if (row and row['state'] == 'healthy' and row['pid'] != old_pid
                and status['controller']['readmitted'] > readmitted):
            return time.monotonic() - t0
        time.sleep(0.1)
    fail('19: replica %r was not respawned healthy within %d s: %s'
         % (victim, deadline_s, rc.status()))


def fleet_round(rc, gw_port, admin, model, count, label, seed, respawn,
                on_hold=None):
    """19(b)/(c): ``count`` sessions against ``model`` held after GW_HOLD
    plies, the replica holding most of them SIGKILLed, the sessions
    released once the gateway has rebuilt them, played to their outcomes;
    with ``respawn``, until the victim is back healthy. ``on_hold()``
    runs while every session is held (its result under 'on_hold').
    Returns the round's numbers."""
    import random
    import threading
    from handyrl_tpu_torch.serving.gateway import GatewayClient
    hold = threading.Barrier(count + 1, timeout=300)
    release = threading.Barrier(count + 1, timeout=300)
    results, errors = [None] * count, []

    def play(i):
        client = GatewayClient('127.0.0.1', gw_port, timeout=120,
                               name='chip%s%d' % (label, i))
        held = False
        try:
            rng = random.Random(seed + i)
            reply = client.open('HungryGeese', model=model, seed=seed + i)
            sid, plies = reply['sid'], 0
            while not reply['done']:
                if not held and plies >= GW_HOLD:
                    held = True
                    hold.wait()
                    release.wait()
                action = (rng.choice(reply['legal']) if reply['to_move']
                          else None)
                reply = client.play(sid, action)
                plies += 1
            results[i] = {'sid': sid, 'plies': plies,
                          'outcome': reply['outcome']}
        except Exception as exc:   # noqa: BLE001 — reported below
            errors.append('%s %d: %s: %s' % (label, i, type(exc).__name__,
                                              exc))
            hold.abort()
            release.abort()
        finally:
            if not held:
                try:
                    hold.wait()
                    release.wait()
                except threading.BrokenBarrierError:
                    pass
            client.close()

    before = admin.status()
    t0 = time.monotonic()
    threads = [threading.Thread(target=play, args=(i,), daemon=True)
               for i in range(count)]
    for t in threads:
        t.start()
    try:
        hold.wait()
    except threading.BrokenBarrierError:
        fail('19(%s): a session failed before the kill: %s'
             % (label, errors))
    held = on_hold() if on_hold else None
    sessions = admin.sessions()
    by_replica = {}
    for row in sessions:
        by_replica.setdefault(row['replica'], []).append(row['sid'])
    by_replica.pop(None, None)
    if not by_replica:
        fail('19(%s): no live session is booked on a replica: %s'
             % (label, sessions))
    victim = max(sorted(by_replica), key=lambda r: len(by_replica[r]))
    stranded = len(by_replica[victim])
    table = {r['replica']: r for r in rc.replicas()}
    readmitted = rc.status()['controller']['readmitted']
    counts = replica_status(rc)
    os.kill(table[victim]['pid'], signal.SIGKILL)
    t_kill = time.monotonic()
    # hold until the gateway's monitor has rebuilt every session it had on
    # the victim (a ply sent first would move the session to a survivor
    # with its cached state, and nothing would be rebuilt)
    while time.monotonic() - t_kill < 120:
        now = admin.status()
        done = (now['reconstructs'] + now['dropped']
                - before['reconstructs'] - before['dropped'])
        if done >= stranded:
            break
        time.sleep(0.05)
    else:
        fail('19(%s): the gateway rebuilt %d of %d stranded sessions in '
             '120 s: %s' % (label, done, stranded, now))
    rebuild_s = time.monotonic() - t_kill
    try:
        release.wait()
    except threading.BrokenBarrierError:
        fail('19(%s): a session failed: %s' % (label, errors))
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errors or any(r is None for r in results):
        fail('19(%s): sessions failed: %s' % (label, errors))
    after = admin.status()
    delta = {k: after[k] - before[k] for k in (
        'opened', 'outcomes', 'reconstructs', 'replayed_plies',
        'mismatches', 'dropped', 'handoffs', 'plies')}
    if (delta['outcomes'] != count or delta['reconstructs'] < 1
            or delta['mismatches'] or delta['dropped']):
        fail('19(%s): gateway %s over the round (%d sessions, %d on the '
             'victim %r)' % (label, delta, count, stranded, victim))
    # the next round kills again: the respawn must be back first
    respawn_s = (wait_respawn(rc, victim, table[victim]['pid'], readmitted)
                 if respawn else None)
    return {'victim': victim, 'stranded_sessions': stranded,
            'by_replica': {k: len(v) for k, v in by_replica.items()},
            'gateway': delta, 'rebuild_s': rebuild_s,
            'respawn_s_after_round': respawn_s, 'wall_s': wall,
            'matches_per_s': count / wall,
            'plies': sum(r['plies'] for r in results),
            'counts_before_kill': counts, 'on_hold': held}


def ab_round(port, label, seed):
    """GW_SESSIONS clients against the gateway on ``port``, AB_MATCHES
    matches each back to back, no kill: the wall seconds, the matches and
    every ply's round trip (ms)."""
    import random
    import threading
    from handyrl_tpu_torch.serving.gateway import GatewayClient
    ply_ms, errors = [], []
    lock = threading.Lock()

    def play(i):
        client = GatewayClient('127.0.0.1', port, timeout=120,
                               name='chip%s%d' % (label, i))
        rng = random.Random(seed + i)
        mine = []
        try:
            for m in range(AB_MATCHES):
                reply = client.open('HungryGeese', model='default@champion',
                                    seed=seed + AB_MATCHES * i + m)
                sid = reply['sid']
                while not reply['done']:
                    action = (rng.choice(reply['legal']) if reply['to_move']
                              else None)
                    t0 = time.perf_counter()
                    reply = client.play(sid, action)
                    mine.append(1e3 * (time.perf_counter() - t0))
        except Exception as exc:   # noqa: BLE001 — reported below
            errors.append('%s %d: %s: %s' % (label, i, type(exc).__name__,
                                              exc))
        finally:
            client.close()
        with lock:
            ply_ms.extend(mine)

    t0 = time.monotonic()
    threads = [threading.Thread(target=play, args=(i,), daemon=True)
               for i in range(GW_SESSIONS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail('19 A/B %s: sessions failed: %s' % (label, errors))
    return {'wall_s': wall, 'matches': GW_SESSIONS * AB_MATCHES,
            'ply_ms': ply_ms}


def set_tracing(endpoints, trace_dir, on):
    """The ``trace`` op on each serving process at ``endpoints`` ((host,
    port); replicas and gateways answer it alike): tracing into
    ``trace_dir`` at rate 1.0, or off."""
    from handyrl_tpu_torch.serving.client import ServiceClient
    body = ({'op': 'trace', 'dir': trace_dir, 'rate': 1.0} if on
            else {'op': 'trace'})
    for host, port in endpoints:
        client = ServiceClient(host, port, timeout=60)
        try:
            reply = client.call_admin(body)
        finally:
            client.close()
        if reply != {'ok': True, 'dir': trace_dir if on else '',
                     'rate': 1.0}:
            fail('19 A/B: the trace op on %s:%d answered %s'
                 % (host, port, reply))


def telemetry_ab(rc, ports, trace_dir, order):
    """The rounds of ``order`` (as AB_ORDER) on the warm fleet
    (``ports``: the two gateways' by kind), after an untimed round on the
    plain gateway. Returns each arm's matches/s, plies/s and ply p50/p99
    (ms), and each round's p50 and wall (the spread); the sanitized
    gateway and the replicas are traced again after it."""
    from handyrl_tpu_torch.serving.client import parse_endpoint
    replicas = [parse_endpoint(r['endpoint'])
                for r in rc.status()['replicas']
                if r['state'] in ('healthy', 'degraded')]
    if len(replicas) != FLEET_REPLICAS:
        fail('19 A/B: %d replicas routable, not %d'
             % (len(replicas), FLEET_REPLICAS))
    # the plain gateway's workers open their routers' connections in an
    # untimed round first
    ab_round(ports['plain'], 'abwarm', SEED + 1960)
    endpoints = {'replicas': replicas,
                 'plain': [('127.0.0.1', ports['plain'])],
                 'sanitized': [('127.0.0.1', ports['sanitized'])]}
    traced = dict.fromkeys(endpoints, True)
    arms = {}
    for k, (kind, gateway_on, replicas_on) in enumerate(order):
        for group, on in ((kind, gateway_on), ('replicas', replicas_on)):
            if traced[group] != on:
                set_tracing(endpoints[group], trace_dir, on)
                traced[group] = on
        r = ab_round(ports[kind], 'ab%d' % k, SEED + 1970 + 100 * k)
        arm = arms.setdefault('%s_%s' % (kind, AB_ARMS[gateway_on,
                                                       replicas_on]),
                              {'rounds': 0, 'matches': 0, 'wall_s': 0.0,
                               'ply_ms': [], 'round_p50_ms': [],
                               'round_wall_s': []})
        arm['rounds'] += 1
        arm['matches'] += r['matches']
        arm['wall_s'] += r['wall_s']
        arm['ply_ms'] += r['ply_ms']
        arm['round_p50_ms'].append(sorted(r['ply_ms'])[len(r['ply_ms']) // 2])
        arm['round_wall_s'].append(r['wall_s'])
    for group in ('sanitized', 'replicas'):
        if not traced[group]:
            set_tracing(endpoints[group], trace_dir, True)
    out = {}
    for name, arm in arms.items():
        lat = sorted(arm.pop('ply_ms'))
        out[name] = dict(arm, plies=len(lat),
                         matches_per_s=arm['matches'] / arm['wall_s'],
                         plies_per_s=len(lat) / arm['wall_s'],
                         ply_p50_ms=lat[len(lat) // 2],
                         ply_p99_ms=lat[min(len(lat) - 1,
                                            int(0.99 * len(lat)))])
    return out


def phase_fleet_run(repo, prep, ab_order=AB_ORDER):
    """Phase 19, through ``python -m handyrl_tpu_torch``: (a) the serving
    fleet (--serve-fleet, 2 managed replicas on the card): a routed burst
    against the references, one replica SIGKILLed with the burst in
    flight (no client error, every reply the reference's bits), its
    respawn under its old name back to healthy and answering those bits,
    a rolling promote to version 2 warmed by every replica, each
    replica's K1 launches (every forward K1's serving form); (b) the match
    gateway (--gateway) over it: GW_SESSIONS Geese sessions held mid-match
    through a replica's SIGKILL, rebuilt from their journals, played to
    their outcomes, booked in the RatingBook's journal; between (b) and
    (c), the telemetry A/B (:func:`telemetry_ab`, the rounds of
    ``ab_order``) against a second, plain gateway and the sanitized one;
    (c) GW_LSTM_SESSIONS GeeseNetLSTM
    sessions the same way as (b) (their hidden cache and digest are not
    empty); SIGTERM drains the gateways and the fleet to 75. Processes
    only: it does no CUDA work in this process."""
    from handyrl_tpu_torch.serving.fleet import RoutedClient
    from handyrl_tpu_torch.serving.gateway import GatewayClient
    tmp, root = prep['tmp'], prep['root']
    reqs, refs = prep['requests'], prep['refs']
    procs, rc, admin = [], None, None
    out = {'card': nvidia_smi_line()}
    try:
        fport, gport = free_ports(2)
        trace_dir = os.path.join(tmp, 'traces')
        cfg = {'env_args': GEESE_ENV, 'train_args': {
            'seed': SEED, 'telemetry': dict(
                FLEET_TELEMETRY, trace_dir=trace_dir,
                blackbox_dir=os.path.join(tmp, 'blackbox')),
            'serving': {
                'registry_dir': root, 'fleet': {
                    'port': 0, 'replicas': FLEET_REPLICAS,
                    'heartbeat_interval': FLEET_HEARTBEAT,
                    'metrics_port': fport}}}}
        path = os.path.join(tmp, 'fleet.json')
        with open(path, 'w') as f:
            json.dump(cfg, f)
        # the processes take their telemetry from their config (the
        # replicas from the resolver's environment), never from this
        # process's; the sanitizer is set for the gateway alone
        env = {k: v for k, v in os.environ.items()
               if k not in TELEMETRY_ENV + ('HANDYRL_TPU_SANITIZE',)}
        env['PYTHONUNBUFFERED'] = '1'
        logs = {k: (os.path.join(tmp, k + '.out'),
                    os.path.join(tmp, k + '.err'))
                for k in ('fleet', 'gateway', 'gateway_plain')}
        t0 = time.monotonic()
        procs.append(start_session(['handyrl_tpu_torch', '--serve-fleet',
                                    '--config', path, '--device', 'cuda'],
                                   repo, env, logs['fleet']))
        ready = wait_json_line(logs['fleet'][0], 'fleet_ready', procs[0],
                               240)
        out['fleet_ready_s'] = time.monotonic() - t0
        if ready['device'] != 'cuda' or len(ready['table']) != \
                FLEET_REPLICAS:
            fail('19(a): the fleet came up as %s' % ready)
        rc = RoutedClient('127.0.0.1', ready['port'], timeout=60,
                          refresh_interval=0.5)
        names = sorted(r['replica'] for r in rc.replicas())
        # (a) every replica answers the references (its first request
        # loads the snapshot), then the latencies
        for name in names:
            for k in range(4):
                o, legal, seed = reqs[k]
                same_reply('19(a) %s' % name, rc.request(
                    'default@champion', o, legal=legal, seed=seed,
                    replica=name), refs[1][k])
                if rc.last_replica != name:
                    fail('19(a): a request for %s went to %s'
                         % (name, rc.last_replica))
        out['before_kill'] = latencies_ms(rc, reqs[:FLEET_LATENCY])
        victim = names[0]
        table = {r['replica']: r for r in rc.replicas()}
        readmitted = rc.status()['controller']['readmitted']
        counts = replica_status(rc)
        rids = [rc.submit('default@champion', o, legal=legal, seed=seed,
                          replica=victim) for o, legal, seed in reqs]
        os.kill(table[victim]['pid'], signal.SIGKILL)
        replays = rc.replays
        for k, rid in enumerate(rids):
            same_reply('19(a) after the kill', rc.collect(rid), refs[1][k])
        out['replays'] = rc.replays - replays
        if out['replays'] < 1:
            fail('19(a): the kill stranded no request of the burst')
        out['respawn_s'] = wait_respawn(rc, victim, table[victim]['pid'],
                                        readmitted)
        out['resolver'] = resolver_checks(fport, names)
        log('19(a) the resolver after the kill: /metrics scraped in %.2f ms '
            '(%d lines): fleet_replicas %d, fleet_respawns_total %d, '
            'fleet_heartbeat_misses_total %d, hub_disconnects_total %d; '
            'alerts fired %s' % tuple(out['resolver'][k] for k in (
                'scrape_ms', 'lines', 'fleet_replicas', 'respawns',
                'heartbeat_misses_total', 'hub_disconnects_total',
                'alerts_fired')))
        # the router comes back to the respawned replica through its
        # breaker's half-open probe (its backoff opened on every stranded
        # request): until then the survivor answers, with the same bits
        served, k, t_back = 0, 0, time.monotonic()
        while served < 8:
            o, legal, seed = reqs[k % len(reqs)]
            same_reply('19(a) the respawned %s' % victim, rc.request(
                'default@champion', o, legal=legal, seed=seed,
                replica=victim), refs[1][k % len(reqs)])
            k += 1
            if rc.last_replica == victim:
                served += 1
            elif time.monotonic() - t_back > 60:
                fail('19(a): the respawned replica answered nothing in 60 s')
            else:
                time.sleep(0.1)
        out['back_on_respawned_s'] = time.monotonic() - t_back
        out['after_kill'] = latencies_ms(rc, reqs[:FLEET_LATENCY])
        promote = rc.promote('default@2', timeout=300)
        if promote != {'ok': True, 'line': 'default', 'version': '2',
                       'warmed': names}:
            fail('19(a): the rolling promote answered %s' % promote)
        for k, (o, legal, seed) in enumerate(reqs[:16]):
            same_reply('19(a) after the promote', rc.request(
                'default@champion', o, legal=legal, seed=seed), refs[2][k])
        status = replica_status(rc)
        for name, st in status.items():
            k1 = st['kernel_launches'].get('geese_trunk', 0)
            if st['device'] != 'cuda' or k1 < 1 or \
                    k1 != st['engine_batches']:
                fail('19(a): replica %s on %s launched K1 %d times in %d '
                     'forwards (every forward must be K1)'
                     % (name, st['device'], k1, st['engine_batches']))
        out['k1_by_replica_after_a'] = {
            n: st['kernel_launches']['geese_trunk']
            for n, st in status.items()}
        out['a_seconds'] = time.monotonic() - t0
        log('19(a) the fleet (%s): %s' % (nvidia_smi_line(), json.dumps(out)))

        # (b), (c): the gateway over the fleet
        gcfg = json.loads(json.dumps(cfg))
        gcfg['train_args']['serving']['gateway'] = {
            'resolver': '127.0.0.1:%d' % ready['port'],
            'workers': GW_SESSIONS, 'metrics_port': gport}
        gpath = os.path.join(tmp, 'gateway.json')
        with open(gpath, 'w') as f:
            json.dump(gcfg, f)
        procs.append(start_session(['handyrl_tpu_torch', '--gateway',
                                    '--config', gpath], repo,
                                   dict(env, HANDYRL_TPU_SANITIZE='1'),
                                   logs['gateway']))
        # the A/B's plain gateway: no sanitizer, no exporter, a rating
        # journal of its own
        pcfg = json.loads(json.dumps(gcfg))
        pcfg['train_args']['serving']['registry_dir'] = os.path.join(
            tmp, 'plain_gateway')
        pcfg['train_args']['serving']['gateway']['metrics_port'] = 0
        ppath = os.path.join(tmp, 'gateway_plain.json')
        with open(ppath, 'w') as f:
            json.dump(pcfg, f)
        procs.append(start_session(['handyrl_tpu_torch', '--gateway',
                                    '--config', ppath], repo, env,
                                   logs['gateway_plain']))
        gready = wait_json_line(logs['gateway'][0], 'gateway_ready',
                                procs[1], 120)
        pready = wait_json_line(logs['gateway_plain'][0], 'gateway_ready',
                                procs[2], 120)
        admin = GatewayClient('127.0.0.1', gready['port'], timeout=120,
                              name='chip_admin')

        def held_sessions():
            # every session is held (or over): the table stands still
            listed = sorted(r['sid'] for r in scrape(gport)[2].get(
                'sessions') or [])
            booked = sorted(r['sid'] for r in admin.sessions())
            if not listed or listed != booked:
                fail('19(b): the gateway\'s /statusz lists sessions %s while '
                     'it holds %s' % (listed, booked))
            return len(listed)
        out['b'] = fleet_round(rc, gready['port'], admin,
                               'default@champion', GW_SESSIONS, 'b',
                               SEED + 1900, respawn=True,
                               on_hold=held_sessions)
        log('19(b) the gateway, GeeseNet: %s' % json.dumps(out['b']))
        t_ab = time.monotonic()
        out['ab'] = telemetry_ab(rc, {'plain': pready['port'],
                                      'sanitized': gready['port']},
                                 trace_dir, ab_order)
        out['ab_seconds'] = time.monotonic() - t_ab
        log('19 the telemetry A/B (%s): %s' % (nvidia_smi_line(),
                                               json.dumps(out['ab'])))
        # --status against the resolver and the gateway, beside (c)
        status_procs = {'resolver': status_cli(repo, fport),
                        'gateway': status_cli(repo, gport)}
        out['c'] = fleet_round(rc, gready['port'], admin, 'lstm@champion',
                               GW_LSTM_SESSIONS, 'c', SEED + 1950,
                               respawn=False)
        log('19(c) the gateway, GeeseNetLSTM: %s' % json.dumps(out['c']))
        for tier, proc in status_procs.items():
            for line in status_done('19 ' + tier, proc)[:6]:
                log('  --status %s: %s' % (tier, line))
        text, gms, gstatus = scrape(gport)
        opened = prom_values(text, 'gateway_sessions_opened_total').get('')
        drops = prom_values(text, 'gateway_session_drops_total').get('')
        fired = (gstatus.get('alerts') or {}).get('fired') or {}
        # the sanitized gateway's A/B sessions count there too
        ab_sanitized = GW_SESSIONS * AB_MATCHES * sum(
            kind == 'sanitized' for kind, _, _ in ab_order)
        if opened != GW_SESSIONS + GW_LSTM_SESSIONS + ab_sanitized or \
                drops != 0 or \
                not isinstance(gstatus.get('sessions'), list) or \
                'session_drop' in fired:
            fail('19: the gateway\'s /metrics counts %s sessions opened and '
                 '%s drops; /statusz sessions %s, alerts fired %s' % (
                     opened, drops, gstatus.get('sessions'), fired))
        out['gateway_exporter'] = {
            'scrape_ms': gms, 'lines': len(text.splitlines()),
            'opened': opened, 'drops': drops, 'alerts_fired': fired,
            'progress': gstatus.get('progress'), 'slo': gstatus.get('slo')}
        log('19 the gateway\'s /metrics scraped in %.2f ms (%d lines): '
            'gateway_sessions_opened_total %d, gateway_session_drops_total '
            '%d; /statusz progress %s, alerts fired %s' % (
                gms, len(text.splitlines()), opened, drops,
                gstatus.get('progress'), fired))
        journal = json.loads(read_text(os.path.join(
            root, 'league_ratings.json')) or '{}').get('entries', {})
        booked = sum(e.get('games', 0) for name, e in journal.items()
                     if name.startswith('gateway:'))
        if booked != GW_SESSIONS + GW_LSTM_SESSIONS + ab_sanitized or not {
                'default@2', 'lstm@1'} <= set(journal):
            fail('19: the RatingBook journal holds %d gateway games and %s'
                 % (booked, sorted(journal)))
        out['rating_journal'] = {'gateway_games': booked,
                                 'members': sorted(journal)}
        final = replica_status(rc)
        launches = {}
        for reading in (counts, out['b'].pop('counts_before_kill'),
                        out['c'].pop('counts_before_kill'), final):
            for name, st in reading.items():
                # each replica process's last reading (a killed one's
                # before its kill): one count a process
                launches[(name, st['pid'])] = st['kernel_launches']
        # (every replica of (a) ran K1 at each forward, checked above;
        # a later respawn may have served the LSTM line alone, no K1)
        out['launches'] = {'fleet_%s_pid%d' % key: v
                           for key, v in sorted(launches.items())}
        plies = admin.status()['plies']
        admin.close()
        admin = None
        plain = GatewayClient('127.0.0.1', pready['port'], timeout=120,
                              name='chip_admin_plain')
        try:
            plies += plain.status()['plies']
        finally:
            plain.close()
        rc.close()
        rc = None
        for label, proc in (('gateway', procs[1]),
                            ('gateway_plain', procs[2]),
                            ('fleet', procs[0])):
            proc.send_signal(signal.SIGTERM)
            rc_ = proc.wait(timeout=180)
            if rc_ != 75:
                fail('19: the %s exited %s after SIGTERM: %s' % (
                    label, rc_, tail(logs[label][1])))
        found = re.findall(SANITIZER_LINE, read_text(logs['gateway'][1]))
        if len(found) != 1 or found[0][0] != '0' or found[0][2] != '0':
            fail('19: the gateway\'s sanitizer reported %s:\n%s' % (
                found, tail(logs['gateway'][1])))
        out['sanitizer'] = dict(zip(('inversions', 'unnamed', 'leaked'),
                                    map(int, found[0])))
        out['traces'] = fleet_traces(repo, trace_dir, gready['pid'],
                                     ready['pid'], plies)
        log('19 traces and the sanitizer: %s; gateway sanitizer %s' % (
            json.dumps(out['traces']), out['sanitizer']))
        out['seconds'] = time.monotonic() - t0
        print(json.dumps({'phase19': {k: v for k, v in out.items()
                                      if k != 'launches'}}), flush=True)
        return out
    finally:
        if admin is not None:
            admin.close()
        if rc is not None:
            rc.close()
        kill_sessions([p for p in procs if p.poll() is None])
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------ phase 21: the data-parallel plane

# the fused loop of phase 6 (its config, solo layout, full-width GeeseNet,
# torus_impl 'pallas') for DP_EPOCHS epochs, a checkpoint each: plainly;
# through a distributed block of world 1 (the same files and launches);
# over two ranks on the one card (gloo: NCCL takes one card a rank); then
# the two ranks' run directory resumed under a world of 1
DP_EPOCHS = 4
DP_TIMEOUT = 300


def dp_config(tmp, name, extra=None):
    cfg = json.loads(json.dumps(FUSED_CONFIG))
    cfg['train_args'].update({
        'epochs': DP_EPOCHS, 'checkpoint_interval': 1,
        'model_dir': os.path.join(tmp, name, 'models'),
        'metrics_jsonl': os.path.join(tmp, name, 'metrics.jsonl')})
    cfg['train_args'].update(extra or {})
    os.makedirs(os.path.join(tmp, name), exist_ok=True)
    path = os.path.join(tmp, name, 'config.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    return path


def dp_start(repo, cfg, tmp, label, env=None):
    """``python -m handyrl_tpu_torch.train --config cfg --device cuda``, its
    output to files: (process, stdout path, stderr path)."""
    out = os.path.join(tmp, label + '.out')
    err = os.path.join(tmp, label + '.err')
    with open(out, 'w') as fo, open(err, 'w') as fe:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             cfg, '--device', 'cuda'], cwd=repo, stdout=fo, stderr=fe,
            env=dict(os.environ, **(env or {})))
    return proc, out, err


def dp_wait(runs, label):
    """Each run's (JSON line, stdout); fails unless each exits 0 with one
    JSON line. Kills every run still going at the deadline."""
    deadline = time.monotonic() + DP_TIMEOUT
    results = []
    try:
        for proc, out, err in runs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for proc, _, _ in runs:
            proc.kill()
        fail('%s did not finish within %d s' % (label, DP_TIMEOUT))
    for proc, out, err in runs:
        text = read_text(out)
        if proc.returncode != 0:
            fail('%s exited %d:\n%s\n%s' % (label, proc.returncode,
                                            text[-2000:],
                                            read_text(err)[-4000:]))
        lines = [l for l in text.splitlines() if l.startswith('{"device"')]
        if len(lines) != 1:
            fail('%s printed %d JSON lines' % (label, len(lines)))
        results.append((json.loads(lines[0]), text))
    return results


def dp_check_run(label, line, epochs, ranks=1):
    """The fused loop ran (sharded over the ranks), closed its epochs and
    launched every kernel of its paths."""
    import math
    if line['model_epoch'] != epochs or not line['steps'] > 0:
        fail('%s: epoch %d, %d steps' % (label, line['model_epoch'],
                                         line['steps']))
    if not all(math.isfinite(v) for v in line['losses'].values()):
        fail('%s: losses %s' % (label, line['losses']))
    for path, kernels in FUSED_PATHS.items():
        counts = line['kernel_launches'].get(path, {})
        missing = [k for k in kernels if not counts.get(k)]
        if missing:
            fail('%s: no launch of %s under %r (%s)' % (label, missing, path,
                                                        counts))
    mesh = line.get('mesh')
    if (ranks > 1) != (mesh is not None):
        fail('%s: mesh %s in a world of %d' % (label, mesh, ranks))


def phase_dp(repo):
    """Phase 21 in processes of its own (no CUDA work in this one)."""
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix='chip_smoke_dp_')
    try:
        return dp_runs(repo, tmp, t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dp_runs(repo, tmp, t0):
    port_a, port_b = free_ports(2)
    # (a) plainly, and through a distributed block of world 1, at once
    plain = dp_config(tmp, 'plain')
    world1 = dp_config(tmp, 'world1', {'distributed': {
        'coordinator_address': 'localhost:%d' % port_a,
        'num_processes': 1, 'process_id': 0}})
    (a_line, _), (w_line, w_out) = dp_wait(
        [dp_start(repo, plain, tmp, 'plain'),
         dp_start(repo, world1, tmp, 'world1')], '21(a)')
    dp_check_run('21(a) plain', a_line, DP_EPOCHS)
    dp_check_run('21(a) world 1', w_line, DP_EPOCHS)
    if 'multi-host: process 0 of 1, 1 global devices' not in w_out:
        fail('21(a): the world-1 run printed no multi-host line')
    same_files = {}
    for name in ['latest.ckpt', 'trainer_state.ckpt'] + [
            '%d.ckpt' % e for e in range(1, DP_EPOCHS + 1)]:
        with open(os.path.join(tmp, 'plain', 'models', name), 'rb') as f:
            a = f.read()
        with open(os.path.join(tmp, 'world1', 'models', name), 'rb') as f:
            b = f.read()
        same_files[name] = a == b
    if not all(same_files.values()):
        fail('21(a): the world-1 run wrote other bytes than the plain run: '
             '%s' % same_files)
    if a_line['kernel_launches'] != w_line['kernel_launches']:
        fail('21(a): launches %s plainly, %s in a world of 1' % (
            a_line['kernel_launches'], w_line['kernel_launches']))
    log('21(a): plain and world-1 runs: %d epochs, %d steps, checkpoint '
        'bytes equal (%d files), launches equal %s; episodes/s %s, SGD '
        'steps/s %s (plain, world 1; the two at once)'
        % (DP_EPOCHS, a_line['steps'], len(same_files),
           a_line['kernel_launches'],
           [round(l['episodes_per_s'], 2) for l in (a_line, w_line)],
           [round(l['sgd_steps_per_s'], 2) for l in (a_line, w_line)]))
    t_a = time.monotonic()

    # (b) two ranks on the one card, by the JAX package's variables
    two = dp_config(tmp, 'two')
    runs = [dp_start(repo, two, tmp, 'rank%d' % r, env={
        'JAX_COORDINATOR_ADDRESS': 'localhost:%d' % port_b,
        'JAX_NUM_PROCESSES': '2', 'JAX_PROCESS_ID': str(r)})
        for r in range(2)]
    ranks = dp_wait(runs, '21(b)')
    digests = []
    for r, (line, out) in enumerate(ranks):
        dp_check_run('21(b) rank %d' % r, line, DP_EPOCHS, ranks=2)
        if 'sharded over 2 devices' not in out or \
                'collectives: gloo, ranks share a card' not in out:
            fail('21(b) rank %d: not the sharded loop over gloo:\n%s'
                 % (r, out[:2000]))
        mesh = line['mesh']
        if mesh['shape'] != {'data': 2, 'model': 1} or mesh['process'] != r:
            fail('21(b) rank %d: mesh %s' % (r, mesh))
        digests.append(mesh['params_sha256'])
    if digests[0] != digests[1] or digests[0] is None:
        fail('21(b): the ranks end with other params: %s' % digests)
    lines = [line for line, _ in ranks]
    if lines[0]['steps'] != lines[1]['steps'] or \
            lines[0]['episodes'] != lines[1]['episodes']:
        fail('21(b): the ranks counted other steps or episodes')
    with open(os.path.join(tmp, 'two', 'models',
                           'trainer_state.ckpt.layout')) as f:
        layout = json.load(f)
    if layout.get('mesh') != {'data': 2, 'model': 1} or \
            layout.get('processes') != 2:
        fail('21(b): the layout manifest reads %s' % layout)
    coll = [line['mesh']['collective'] for line in lines]
    log('21(b): two ranks on one card (gloo): %d epochs, %d steps, %d '
        'episodes, params sha256 %s on both; layout %s; the collective a '
        'step (%d bytes): CUDA events %s ms, host clock %s ms by rank; '
        'episodes/s %s, SGD steps/s %s by rank'
        % (DP_EPOCHS, lines[0]['steps'], lines[0]['episodes'],
           digests[0][:16], describe_layout(layout),
           coll[0]['bytes_per_call'],
           [round(c['cuda_ms_per_call'], 4) for c in coll],
           [round(c['host_ms_per_call'], 4) for c in coll],
           [round(l['episodes_per_s'], 2) for l in lines],
           [round(l['sgd_steps_per_s'], 2) for l in lines]))
    t_b = time.monotonic()

    # (c) the two ranks' run directory resumed under a world of 1
    resume = dp_config(tmp, 'resume', {
        'model_dir': os.path.join(tmp, 'two', 'models'),
        'restart_epoch': -1, 'epochs': DP_EPOCHS + 1})
    ((c_line, c_out),) = dp_wait([dp_start(repo, resume, tmp, 'resume')],
                                 '21(c)')
    dp_check_run('21(c) resume', c_line, DP_EPOCHS + 1)
    want = ('mesh-portable restore: checkpoint written under data=2xmodel=1 '
            '(2 process(es)), restoring onto single device (1 process(es))')
    if want not in c_out or 'resumed trainer state (steps %d)' % lines[0][
            'steps_at_exit'] not in c_out:
        fail('21(c): no restore line:\n%s' % c_out[:3000])
    if not c_line['steps_at_exit'] > c_line['steps_at_start'] == \
            lines[0]['steps_at_exit']:
        fail('21(c): steps %d -> %d after the two ranks\' %d' % (
            c_line['steps_at_start'], c_line['steps_at_exit'],
            lines[0]['steps_at_exit']))
    t_c = time.monotonic()
    log('21(c): resumed under a world of 1 at steps %d: %s; epoch %d, '
        'steps %d' % (c_line['steps_at_start'], want, c_line['model_epoch'],
                      c_line['steps_at_exit']))
    log('phase 21: (a) %.1f s, (b) %.1f s, (c) %.1f s (%s)' % (
        t_a - t0, t_b - t_a, t_c - t_b, nvidia_smi_line()))
    return {'plain': a_line, 'world1': w_line, 'ranks': lines,
            'resume': c_line, 'collective': coll,
            'seconds': {'a': t_a - t0, 'b': t_b - t_a, 'c': t_c - t_b}}


def describe_layout(layout):
    mesh = layout.get('mesh') or {}
    return 'x'.join('%s=%d' % (k, mesh[k]) for k in sorted(mesh)) or \
        'single device'


def main():
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs a card')
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, 'handyrl_tpu_torch')):
        fail('handyrl_tpu_torch/ is not beside this script: run it from a '
             'checkout of the repository')
    sys.path.insert(0, repo)
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.ops import cuda_build, geese_trunk, targets

    t_start = time.monotonic()
    smi = nvidia_smi_line()
    log('card: %s | torch %s, CUDA %s, %d device(s)' % (
        smi, torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))

    timer = {'t': time.monotonic()}

    def took(name):
        """Log the seconds since the last phase ended (and the card)."""
        now = time.monotonic()
        log('%s: %.1f s (%s)' % (name, now - timer['t'], nvidia_smi_line()))
        timer['t'] = now

    log('== phase 1: build')
    hmma = phase_build(cuda_build)
    took('phase 1')

    log('== phase 2: kernels against their plain versions')
    rows = phase_kernels(torch, geese_trunk, GeeseNet, make_env)
    bwd_rows = phase_backward(torch, geese_trunk, GeeseNet, make_env)
    phase_narrow(torch, geese_trunk)
    target_rows = phase_targets(torch, targets)
    took('phase 2')
    bf16_kernel_rows = phase_bf16_kernels(torch, geese_trunk, GeeseNet,
                                          make_env)
    took('phase 15(a)')

    log('== phase 3: main path (serving)')
    launches = phase_main_path(torch, repo)
    took('phase 3')

    log('== phase 4: main path (training)')
    train = phase_training(torch, repo, make_env)
    took('phase 4')

    log('== phase 5: main path (the local learner)')
    learner = phase_learner(torch, repo, make_env, train['bench'])
    took('phase 5')

    log('== phase 5(b): the local learner with batcher processes and '
        'shared-memory batches')
    learner_shm = phase_learner_shm(torch, repo, make_env, train['bench'],
                                    learner)
    took('phase 5(b)')

    fused_tmp = tempfile.mkdtemp(prefix='chip_smoke_fused_')
    # phase 6's last checkpoint, kept for phase 11 (phase 8's drill trims
    # the model dir)
    opponent_tmp = tempfile.mkdtemp(prefix='chip_smoke_opponent_')
    opponent = os.path.join(opponent_tmp, '%d.ckpt' % FUSED_EPOCHS)
    # phase 7's checkpoints, kept for the SWA tool (beside phase 19)
    swa_tmp = tempfile.mkdtemp(prefix='chip_smoke_swa_')
    try:
        log('== phase 6: main path (the fused device loop)')
        fused = phase_fused(torch, repo, make_env, learner, fused_tmp)
        shutil.copy(os.path.join(fused_tmp, 'models', '%d.ckpt'
                                 % FUSED_EPOCHS), opponent)
        took('phase 6')

        log('== phase 7: main path (the quick start: TicTacToe, turn-based)')
        quick = phase_quick_start(torch, repo, make_env, target_rows,
                                  keep=swa_tmp)
        took('phase 7')

        log('== phase 7(b): the quick start with batcher processes and '
            'shared-memory batches')
        quick_shm = phase_quick_shm(torch, repo, quick)
        took('phase 7(b)')

        log('== phase 7(c): the quick start on the fused device loop (turn '
            'mode)')
        quick_fused = phase_quick_fused(torch, repo, make_env, quick)
        took('phase 7(c)')

        # 9(a)'s processes run beside phase 8's (independent: phase 8
        # reads phase 6's model dir, 9(a) writes its own), to fit the time
        # limit
        log('== phase 8: main path (phase 6\'s checkpoints scored offline; '
            'a preemption drill), beside phase 9(a)')
        log('== phase 9(a): main path (the worker plane: a local worker '
            'cluster)')
        scored, workers_local = concurrently(
            lambda: phase_score_and_drill(repo, fused_tmp),
            lambda: phase_workers_local(torch, repo, make_env, learner))
        took('phases 8 and 9(a)')
    finally:
        shutil.rmtree(fused_tmp, ignore_errors=True)

    # 9(b)'s processes run beside phase 10 (independent: free ports and
    # the battle port), at once to fit the time limit
    t10 = time.monotonic()
    log('== phase 9(b): main path (the worker plane: a training server and '
        'a worker host over TCP, one gather killed), beside phase 10')
    log('== phase 10: main path (network battles and the registry:// and '
        'serve:// specs through python -m handyrl_tpu_torch)')
    workers_remote, network = concurrently(
        lambda: phase_workers_remote(torch, repo),
        lambda: phase_network(torch, repo, make_env))
    log('phases 9(b) and 10: %.1f s (%s)' % (time.monotonic() - t10,
                                             nvidia_smi_line()))

    # phase 21's processes (the data-parallel plane) run beside phases 11
    # and 12, to fit the time limit
    log('== phase 21: the data-parallel plane (its processes beside phases '
        '11 and 12)')
    dp_join = in_background(lambda: phase_dp(repo))
    t11 = time.monotonic()
    try:
        branches = phase_device_branches(torch, repo, GeeseNet, make_env,
                                         opponent, learner, fused)
    finally:
        shutil.rmtree(opponent_tmp, ignore_errors=True)
    log('phase 11: %.1f s (%s)' % (time.monotonic() - t11,
                                   nvidia_smi_line()))

    t12 = time.monotonic()
    actor = phase_device_actor(torch, repo, GeeseNet, make_env)
    log('phase 12: %.1f s (%s)' % (time.monotonic() - t12,
                                   nvidia_smi_line()))
    dp = dp_join()
    log('phase 21: %.1f s since its start, beside 11 and 12\'s %.1f s (%s)'
        % (sum(dp['seconds'].values()), time.monotonic() - t11,
           nvidia_smi_line()))

    # phase 14's learner processes run beside phase 13, to fit the time
    # limit (PERF.md §4)
    geister_tmp = tempfile.mkdtemp(prefix='chip_smoke_geister_learners_')
    try:
        log('== phase 14(b)/(c)/(f) begin, beside phase 13')
        geister_join = in_background(
            lambda: geister_learner_group(torch, repo, geister_tmp))
        t13 = time.monotonic()
        cx_lstm = phase_connectx_lstm(torch, repo, make_env)
        log('phase 13: %.1f s (%s)' % (time.monotonic() - t13,
                                       nvidia_smi_line()))

        t14 = time.monotonic()
        geister = phase_geister(torch, repo, make_env, geister_join)
    finally:
        shutil.rmtree(geister_tmp, ignore_errors=True)
    log('phase 14: %.1f s (%s)' % (time.monotonic() - t14,
                                   nvidia_smi_line()))

    t15 = time.monotonic()
    bf16 = phase_bf16_former(torch, repo, make_env, bf16_kernel_rows)
    log('phase 15: %.1f s (%s)' % (time.monotonic() - t15,
                                   nvidia_smi_line()))

    # phase 19's part in this process (the registry, the references, the
    # LSTM's bucket check) comes first; its processes (the fleet, the
    # gateway, driven from a thread that does no CUDA work) then run
    # beside phases 16, 17 and 18, to fit the time limit
    t19 = time.monotonic()
    log('== phase 19: the serving fleet and the match gateway (its '
        'processes beside phases 16, 17 and 18, as is the SWA tool\'s)')
    swa_join = in_background(lambda: phase_swa(repo, swa_tmp))
    fleet_prep = phase_fleet_prepare(torch, make_env, GeeseNet)
    log('phase 19 (in process): %.1f s (%s)' % (time.monotonic() - t19,
                                                 nvidia_smi_line()))
    fleet_join = in_background(lambda: phase_fleet_run(repo, fleet_prep))

    t16 = time.monotonic()
    durable = phase_durable(torch, repo, make_env)
    log('phase 16: %.1f s (%s)' % (time.monotonic() - t16,
                                   nvidia_smi_line()))

    # phase 17 (the league) runs beside 18(c) and (d): independent
    # learner processes, at once to fit the time limit
    t17 = time.monotonic()
    log('== phase 17: the league on the worker plane and the device actor '
        '(beside phase 18(c) and (d))')
    engine, league_run = phase_engine(
        torch, repo, GeeseNet, make_env, workers_local,
        beside=lambda: phase_league(torch, repo, make_env))
    log('phases 17 and 18: %.1f s (%s)' % (time.monotonic() - t17,
                                           nvidia_smi_line()))
    fleet = fleet_join()
    try:
        swa_join()
    finally:
        shutil.rmtree(swa_tmp, ignore_errors=True)
    log('phase 19: %.1f s since its start (%s)' % (
        time.monotonic() - t19, nvidia_smi_line()))

    log('== phase 20: the kernels line')
    # launches on each main path: serving, the bench entry (both forms),
    # the in-process steps of each form and config, the learner by its
    # paths (each run with the counts at 0 just before; a graph's replays
    # counted by bookkeeping)
    paths = dict(train['paths'], serving=launches)
    for name, counts in learner['kernel_launches'].items():
        paths['learner_' + name] = counts
    for name, counts in learner_shm['kernel_launches'].items():
        paths['learner_shm_' + name] = counts
    for name, counts in fused['line']['kernel_launches'].items():
        paths['learner_fused_' + name] = counts
    for name, counts in quick['line']['kernel_launches'].items():
        paths['quick_start_' + name] = counts
    for name, counts in quick_shm['line']['kernel_launches'].items():
        paths['quick_start_shm_' + name] = counts
    for name, counts in quick_fused['line']['kernel_launches'].items():
        paths['quick_start_fused_' + name] = counts
    for name, counts in scored['score_summary']['kernel_launches'].items():
        paths['score_' + name] = counts
    for label, line in (('workers_local', workers_local),
                        ('workers_remote', workers_remote)):
        for name, counts in line['kernel_launches'].items():
            paths['%s_%s' % (label, name)] = counts
        paths[label + '_worker_processes'] = line['worker_kernel_launches']
    # phase 10: the eval clients' children (each a fresh process) and the
    # service under serve:// (its counts 0 just before)
    paths['network_geese_client_children'] = network['geese']['launches']
    paths['network_wire_client_children'] = network['wire']['launches']
    paths['network_tictactoe_client_children'] = network['ttt']['launches']
    paths['network_serve_service'] = network['specs']['launches']
    # phase 11: the device branches by launch path, and the exported
    # program's K1 through the registered operator (a fresh process)
    for label in ('split', 'replay', 'host_push'):
        for name, counts in branches[label]['line'][
                'kernel_launches'].items():
            paths['%s_%s' % (label, name)] = counts
    paths['export_exported_model'] = branches['export']['launches']
    # phase 12: the engine's blocks in this process (counts 0 just before),
    # the learners and their device actor gathers (fresh processes)
    paths['device_actor_engine'] = actor['geese']['launches']
    for label in ('local', 'remote'):
        for name, counts in actor[label]['kernel_launches'].items():
            paths['device_actor_%s_%s' % (label, name)] = counts
        paths['device_actor_%s_gather' % label] = actor[label][
            'gather_launches']
    # phase 13: the ConnectX and GeeseNetLSTM learners by their launch
    # paths (fresh processes), the LSTM service (its counts 0 at start)
    for net_name, part in (('connectx', cx_lstm['connectx']),
                           ('lstm', cx_lstm['lstm'])):
        for label in ('host', 'fused'):
            for name, counts in part[label]['kernel_launches'].items():
                paths['%s_%s_%s' % (net_name, label, name)] = counts
    paths['lstm_service'] = cx_lstm['lstm']['serving']['launches']
    # phase 14: the Geister and ParallelTicTacToe learners by their launch
    # paths (fresh processes), the in-process graphed 'batch' steps (counts
    # 0 just before each), the Geister service and device actor block
    for label, part in (('geister_host', geister['host']),
                        ('geister_fused', geister['fused']),
                        ('parallel_tictactoe_host',
                         geister['parallel_tictactoe'])):
        for name, counts in part['kernel_launches'].items():
            paths['%s_%s' % (label, name)] = counts
    paths['geister_recurrent_step'] = geister['step']['launches']
    paths['geese_batch_norm_step'] = geister['geese_bn']['launches']
    paths['geister_service'] = geister['serving']['launches']
    paths['geister_device_actor'] = geister['actor']['launches']
    # phase 15: the bf16 bench (a fresh process), the in-process graphed
    # bf16 steps (counts 0 just before), the bf16 fused loop (a fresh
    # process) and TicTacToe learner, and GeeseFormer's service, learner
    # and graphed step
    paths['bf16_bench'] = bf16['bench']['kernel_launches']
    paths['bf16_step_graphed'] = bf16['step']['launches']
    for label, part in (('bf16_fused', bf16['fused']),
                        ('bf16_tictactoe', bf16['tictactoe']),
                        ('former_fused', bf16['former'])):
        for name, counts in part['kernel_launches'].items():
            paths['%s_%s' % (label, name)] = counts
    paths['former_service'] = bf16['serving']['launches']
    paths['former_step'] = bf16['former']['step_launches']
    # phase 16: the graphed IMPACT steps (counts 0 just before), the
    # restarted durable learner and its surviving device actor gather
    # (fresh processes), the streaming TicTacToe server
    paths['impact_step'] = durable['impact']['launches']
    for name, counts in durable['drill']['kernel_launches'].items():
        paths['durable_drill_%s' % name] = counts
    paths['durable_drill_gather'] = durable['drill']['gather_launches']
    for name, counts in durable['stream']['kernel_launches'].items():
        paths['stream_chaos_%s' % name] = counts
    # phase 17: the league's learner by its launch paths, its device actor
    # gather and F6's service (fresh processes)
    for name, counts in league_run['kernel_launches'].items():
        paths['league_%s' % name] = counts
    paths['league_gather'] = league_run['gather_launches']
    paths['league_service'] = league_run['service_launches']
    # phase 18: the engine runs' learners by their launch paths, their
    # gathers' engines, their worker processes (nothing until a failover)
    # and the service (fresh processes); (b)'s ticks in this process
    for label in ('local', 'chaos', 'remote'):
        part = engine[label]
        for name, counts in part['kernel_launches'].items():
            paths['engine_%s_%s' % (label, name)] = counts
        paths['engine_%s_worker_processes' % label] = part[
            'worker_kernel_launches']
    paths['engine_local_gather'] = engine['local']['gather_launches']
    paths['engine_chaos_gather'] = engine['chaos']['gather_launches']
    paths['engine_remote_service'] = engine['remote']['service_launches']
    paths['engine_buckets'] = engine['buckets']['launches']
    # phase 19: each fleet replica process (the respawned ones too), read
    # from its status reply before its kill or the drain
    paths.update(fleet['launches'])
    # phase 21: the fused loop plainly, in a world of 1, each of the two
    # ranks on the card, and the resume (fresh processes)
    for label, line in (('dp_plain', dp['plain']),
                        ('dp_world1', dp['world1']),
                        ('dp_rank0', dp['ranks'][0]),
                        ('dp_rank1', dp['ranks'][1]),
                        ('dp_resume', dp['resume'])):
        for name, counts in line['kernel_launches'].items():
            paths['%s_%s' % (label, name)] = counts

    def entry(name, source, replaces, main_row, by_n, count=None, **extra):
        count = count or name   # the wrapper count the launches are read from
        row = {'name': name, 'route': 'cuda',
               'source': 'handyrl_tpu_torch/csrc/' + source,
               'replaces': replaces,
               'launches': sum(p.get(count, 0) for p in paths.values()),
               'launches_by_path': {k: p.get(count, 0)
                                    for k, p in paths.items()},
               'max_abs_err': max(r['max_abs_err'] for r in by_n.values()),
               'peaks': PEAK_SOURCE}
        row.update({k: main_row[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                             'bound_by', 'library_ms', 'n')})
        row['by_n'] = {str(n): {k: r[k] for k in (
            'max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms')}
            for n, r in by_n.items()}
        row.update(extra)
        return row

    kernels = [
        entry('geese_trunk', 'geese_trunk.cu',
              'handyrl_tpu/ops/pallas_geese.py:108', rows[MAIN_PATH_N], rows,
              train_ms={str(n): rows[n]['train_ms'] for n in SAVED_NS},
              train_bound_ms={str(n): rows[n]['train_bound_ms']
                              for n in SAVED_NS},
              device_ms={str(n): r['device_ms'] for n, r in rows.items()},
              sass_hmma=hmma.get('trunk_fwd_kernel<32,float>', 0),
              op={str(n): r for n, r in branches['export']['op'].items()},
              engine={'buckets': engine['local']['buckets'],
                      'fill_ratio': engine['local']['fill_ratio'],
                      'k1_per_net_ply': engine['local']['k1_per_net_ply'],
                      'bucket_invariant': engine['buckets']['bitwise']},
              fleet={'k1_by_replica_after_a': fleet[
                  'k1_by_replica_after_a'],
                  'lstm_bucket_invariant': fleet_prep['lstm_buckets'][
                      'bitwise']}),
    ]
    # K2 as its two phases: each wrapper call launches each phase once
    notes = {'a': dict(plain_and_library_ms_are='of the whole K2'),
             'b': dict(plain_ms_is='the 13 plain weight grads',
                       library_ms_is='cuDNN\'s weight grads of the 13 torus '
                       'convs (conv2d_weight, fp32), by CUDA-graph replay',
                       sass_hmma=hmma.get('trunk_wgrad_kernel<32,float>',
                                          0))}
    for phase, kernel_names in PHASES.items():
        by_n = {n: dict(r, **r[phase]) for n, r in bwd_rows.items()}
        kernels.append(entry(
            'geese_trunk_bwd_' + phase, 'geese_trunk.cu',
            'handyrl_tpu/ops/pallas_geese.py:115', by_n[TRAIN_N], by_n,
            count='geese_trunk_bwd', kernels=kernel_names,
            k2_ms=bwd_rows[TRAIN_N]['ms'],
            max_abs_err_is='of K2\'s grads, relative to each grad\'s '
            'largest element', **notes[phase]))
    # the bf16 forms, rows of their own: K1 at the serving bucket (its
    # training form by N beside it), K2's phases at the fused loop's step
    fwd16, bwd16 = bf16['fwd'], bf16['bwd']
    kernels.append(entry(
        'geese_trunk_bf16', 'geese_trunk.cu',
        'handyrl_tpu/ops/pallas_geese.py:108', fwd16[BF16_MAIN_N], fwd16,
        peak_flops='989 TFLOP/s dense bf16 (H100 SXM data sheet)',
        max_abs_err_is='of y, relative to its largest element',
        train_ms={str(n): r['train_ms'] for n, r in fwd16.items()},
        train_bound_ms={str(n): r['train_bound_ms']
                        for n, r in fwd16.items()},
        sass_hmma=hmma.get('trunk_fwd_kernel<32,bf16>', 0)))
    notes16 = {'a': dict(plain_and_library_ms_are='of the whole K2 (library: '
                         'autograd through the \'pad\' trunk in bf16)'),
               'b': dict(plain_ms_is='the 13 plain weight grads',
                         library_ms_is='cuDNN\'s bf16 weight grads of the 13 '
                         'torus convs, by CUDA-graph replay',
                         sass_hmma=hmma.get('trunk_wgrad_kernel<32,bf16>',
                                            0))}
    for phase, kernel_names in PHASES.items():
        by_n = {n: dict(r, **r[phase]) for n, r in bwd16.items()}
        kernels.append(entry(
            'geese_trunk_bwd_bf16_' + phase, 'geese_trunk.cu',
            'handyrl_tpu/ops/pallas_geese.py:115', by_n[BF16_TRAIN_N], by_n,
            count='geese_trunk_bwd_bf16', kernels=kernel_names,
            k2_ms=bwd16[BF16_TRAIN_N]['ms'],
            peak_flops='989 TFLOP/s dense bf16 (H100 SXM data sheet)',
            max_abs_err_is='of K2\'s grads, relative to each grad\'s '
            'largest element', **notes16[phase]))
    for name, line in (('td_lambda', 129), ('upgo', 138), ('vtrace', 149)):
        by_n = {'T%d_P%d_N%d' % key[1:]: r
                for key, r in target_rows.items() if key[0] == name}
        kernels.append(entry(
            name, 'targets.cu', 'handyrl_tpu/ops/pallas_targets.py:%d' % line,
            target_rows[(name,) + TARGET_PATH], by_n, T=TARGET_PATH[0],
            P=TARGET_PATH[1],
            library_ms_none='no single PyTorch call computes the recursion'))
    bench_line = train['bench']
    log('training path: graphed %.1f trajectories/s, %.3f ms a step; eager '
        '%.3f ms a step (B=128, T=16, fp32, host clock); profiled device '
        'busy %s ms, idle share %s' % (
            bench_line['value'], bench_line['step_ms'],
            bench_line['eager_step_ms'],
            {f: round(p['device_busy_ms'], 4)
             for f, p in train['profile'].items()},
            {f: round(p['idle_share'], 4)
             for f, p in train['profile'].items()}))
    log('total %.1f s' % (time.monotonic() - t_start))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
