#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

Run from the repository root, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit:

    python3 chip_smoke.py

Four paths, each driven through its trainer's entry point with every
kernel launch counter set to 0 just before and read just after: CIFAR-10
ResNet-32 K-FAC training (slice 1, since grown to CIFAR-format data,
evaluation, checkpoints, logs, diagnostics, the inverse method, diagonal
blocks and gradient accumulation), transformer-LM K-FAC training with a
K-FAC token embedding and flash attention (slice 2; also with a tied
head), ImageNet ResNeXt-50 32x4d K-FAC training with grouped-conv K-FAC
(slice 3; also ResNet-50 on numpy shards with augmentation, evaluation
and checkpoint import, through the numpy pipeline and the native threaded
loader), each image path also in the bfloat16 modes
(``--bf16 --eigen-dtype bf16``, slice 9), WikiText LSTM K-FAC training,
the data-parallel K-FAC (slice 11) at world 1 on NCCL and on two ranks
of the one card, the pipelined refresh and the truncated solvers
(slice 12) on the ResNet, LM and WikiText paths and on two ranks, and the
factor comm plane (slice 13: bucketed, bf16, deferred and int8 factor
wires) with the LM and WikiText twins at NCCL world 1 and on two ranks.
Kernels 1, 1g and 3 have two routes each, counted apart
(``launches`` and ``launches_bf16``): 3xTF32 for float32 inputs, and a
bf16 route for bfloat16 activations (1, 1g) or bfloat16 eigenvectors (3).
``python3 chip_smoke.py --profile-edges N`` instead builds the kernels and
profiles phase 27a's epoch N times through the trainer as users call it
and N times as 27a does, printing the counted launches each trace lost
(no gate, no result line).

Phases, in order (any failure raises: the script exits non-zero and prints
no result line):

1. require CUDA; print the card's name and power limit (``nvidia-smi``);
2. build the five CUDA sources of ``kfac_pytorch_tpu_torch/csrc/`` (one
   ``nvcc`` per source, all at once) and print each kernel's registers and
   spill bytes from ptxas; the conv A (``patch_cov``), fused apply and
   flash forward kernels must not spill;
3. hold each ResNet kernel against its plain PyTorch version on the inputs
   the ResNet path gives it (batch 128, 32×32 images) and time, with CUDA
   events, the kernel, the plain version and one PyTorch library call for
   the same function (a yardstick only; the port never calls it); kernel 1
   (3xTF32 on the tensor cores) within 1e-5 of the largest plain entry per
   conv, two of its launches bitwise equal, its five costliest conv
   geometries reported with their route (tile, copy width, splits); the
   fused apply (3xTF32) also per shape group, its five costliest groups
   reported with their tile and copy widths, and two of its launches
   bitwise equal;
   kernel 4 (the fused SGD, through the ``SGDPlan`` the train step keeps)
   bitwise equal to its plain version, one device launch per call, its
   device time from the profiler's kernel spans (the L2 cache flushed
   before each call, and back to back) beside the wrapper's wall time and
   ``torch.optim.SGD`` with ``foreach=True`` and with ``fused=True``;
   3b. kernel 1's bf16 route on the activations of a bfloat16 ResNet-32
   forward (all 31 conv inputs, the stem's cast) within 1e-5 of its plain
   version (which upcasts), two launches bitwise equal; kernel 3's bf16-Q
   route at the same groups within 1e-4; timed against the route's bound
   (bf16: FLOPs over 989 TFLOP/s and 2-byte inputs; bf16-Q: two TF32
   products per product and 2-byte Q), the plain version and the
   library yardstick on the upcast input;
4. train ResNet-32 at its published widths on synthetic data (lr 0.1,
   momentum 0.9, wd 5e-4, stat-decay 0.95, damping 0.003, kl-clip 0.001,
   cov-freq 1, kfac-update-freq 10); the loss must be finite and falling
   and every counter must equal what the run implies (per capture step:
   kernel 1 31, kernel 3 once per shape group; kernel 4 once a step);
   ``--kfac-update-freq 0`` gives plain SGD's step time;
5. the same training with ``--factor-kernel dense --apply-kernel dense``
   (the oracle paths) must match the kernel run's first losses;
6. print where the ResNet step's device time goes (``torch.profiler``:
   kernel time by group over 9 capture steps and over 10 plain-SGD steps,
   with the device's idle share); kernel 4 must launch once per K-FAC
   step in the profile (the same gate holds in phases 10 and 14, and on
   the LM kernel 2 once per capture step);
7. the LM kernels at the LM path's shapes (d_model 512, 8 heads of 64,
   4 layers, T 2048, batch 4, vocab 1000): token counts bitwise in one
   device launch and no other device event (no memset, no host sync), ids
   outside the vocabulary raised by the deferred ``check_token_ids``, flash
   forward within 2e-5 of the largest plain entry (and of SDPA's) and its
   dQ and dK/dV within 1e-4, there and at ``FLASH_EDGE_CASES`` (a ragged T,
   no causal mask, D = 32 and 128), two launches of each flash kernel
   bitwise equal, and the apply and SGD kernels at the transformer's shape
   groups and leaves; timed as in phase 3 (the bound of the kernels on the
   tensor cores, 1, 1g, 3 and 5–7, is the TF32 rate, the CUDA cores'
   float32 bound beside it); kernel 3's bf16-Q route at the LM's groups;
8. train the LM for 2 epochs (38 steps, eigen refreshes at steps 0, 10,
   20, 30) through its trainer twin; the loss must be finite and falling
   and every counter must equal what the run implies; one epoch with
   ``--kfac-update-freq 0`` gives plain SGD's step time;
9. the LM oracle path through the library API (exact attention,
   ``factor_kernel="dense"``, ``apply_kernel="dense"``, the same seed and
   batches) must match the kernel path's first 5 losses within 1e-3;
10. print where the LM step's device time goes (10 K-FAC steps holding one
    eigen refresh, 5 capture steps, and 10 plain-SGD steps);
11. the ImageNet kernels on activations of one ResNeXt-50 forward at batch
    32, 224×224: kernel 1g (grouped conv A, one launch per layer for all 32
    groups, C/G = 4, 8, 16, 32) and kernel 1 (the 37 ungrouped convs)
    within 1e-5 of the largest plain entry per layer, two launches of each
    bitwise equal, their costliest geometries with their routes, and the
    apply and SGD kernels at ResNeXt's shape groups (among them 96 × [4,
    36] … 96 × [32, 288]) and leaves; timed as in phase 3;
    11b. kernels 1 and 1g on their bf16 route on a bfloat16 ResNeXt
    forward's activations (37 + 16 convs) and kernel 3's bf16-Q route at
    ResNeXt's groups, as in 3b;
12. train ResNeXt-50 32x4d for 30 steps (refreshes at 0, 10, 20) through
    its trainer twin at the JAX trainer's recipe; the loss must be finite
    and falling and every counter must equal what the run implies (per
    step: kernel 1 37, kernel 1g 16, kernel 3 once per shape group, kernel
    4 once); 10 steps with ``--kfac-update-freq 0`` give plain SGD's step
    time;
13. the oracle paths (``factor_kernel="dense"``, ``apply_kernel="dense"``)
    must match the kernel path's first 5 losses within 1e-3, each oracle
    step taken from the kernel path's state (free-running, this
    configuration carries one step's rounding to ~1e-2 within 4 steps on
    an NVIDIA H100 80GB HBM3 at 700 W, plain SGD's own run-to-run noise
    included);
14. print where the ResNeXt step's device time goes (6 K-FAC steps
    holding one refresh, 3 capture steps, 5 plain-SGD steps);
15. capture one kernel-4 call over ResNeXt's leaf set and one kernel-2
    call on the LM batch in CUDA graphs (a host sync in either wrapper
    fails the capture) and replay each on new inputs: bitwise equal to
    eager calls;
16. the CIFAR-10 main path with data and the JAX trainer's options, each
    through the CIFAR twin with every counter zeroed just before:
    a. write a CIFAR-10 set in the ``cifar-10-batches-py`` layout from the
       learnable stand-in (five train batches of 1,280 images, a test batch
       of 2,000, quantized to uint8) into a temporary directory;
    b. train ResNet-32 on it at the recipe for 2 epochs of 50 steps, its
       batches from the native loader (``--num-workers 4``, pad-4 crop +
       flip), with ``--kfac-diagnostics --bn-recal-batches 5``, a log and a checkpoint
       directory: the loss finite and falling, 2,000 images evaluated each
       epoch, ν in (0, 1] and the min damped eigenvalue ≥ damping every
       step, ``scalars.jsonl`` with the JAX trainer's tags, every counter as
       the run implies; the validation accuracy printed (not gated);
    c. restore phase b's ``checkpoint-0`` into a fresh state (every tensor
       bitwise equal to the saved one); rerun with ``--epochs 2`` on a
       directory that holds only that checkpoint: every one of epoch 1's
       50 losses and its validation loss and accuracy within
       ``RESUME_RTOL`` of phase b's (b and c run with deterministic cuDNN);
    d. 30 steps of the inverse method: kernel 1 as implied, kernels 3 and 4
       never (the dense apply), the first 5 losses within 1e-3 of the
       ``factor_kernel="dense"`` oracle's; its step medians beside phase 4's;
    e. ``--diag-blocks 4 --diag-warmup 1`` over 2 epochs of 10 steps (one
       block at step 0's refresh, four at step 10's): counters as implied,
       the first 5 losses of each epoch within 1e-3 of the oracle's, each
       oracle step from the kernel path's state;
    f. ``--batches-per-allreduce 2`` with and without
       ``--stats-all-microbatches``: kernel 1 once per conv and capture step
       (twice with every microbatch's statistics), the first 5 losses within
       1e-3 of the oracle's;
17. the bfloat16 modes and this slice's bookkeeping, each path through its
    twin with the counters zeroed just before:
    a. ResNet-32 with ``--bf16 --eigen-dtype bf16``, 30 steps: the loss
       finite and falling, counters as implied (per capture step kernel 1
       31 launches, 30 of them on the bf16 route: the stem's input is the
       float32 batch, as in JAX; kernel 3 bf16-Q per group and step; kernel
       4 once a step), the first 5 one-step oracle steps (``"dense"`` in
       the same modes) within ``BF16_ORACLE_RTOL``; step medians beside
       phase 4's;
    b. this slice's path, ResNeXt-50 32x4d at batch 32, 224x224, with
       ``--bf16 --eigen-dtype bf16``, 30 steps through the ImageNet twin,
       gated as in a (kernels 1 bf16 36 + 1 float32, 1g bf16 16 per capture
       step, kernel 3 bf16-Q 19 per step), images/s and step medians beside
       phase 12's, and a profiled window of 3 capture steps;
    c. ``--precond-precision default`` on the ResNet-32 inverse method:
       losses and updates within ``PRECISION_RTOL`` of IEEE float32, the
       matmul flag restored afterwards;
    d. the ImageNet twin at a reduced depth (ResNet-18, 64x64): ``--log-dir``,
       ``--checkpoint-dir`` and a resume within ``RESUME_RTOL``,
       ``--batches-per-allreduce 2``, ``--precond-method inverse``; the LM
       twin: ``--log-dir`` with ``--kfac-diagnostics``, ``--checkpoint-dir``
       and a resume within ``RESUME_RTOL``;
18. the ImageNet data path, each run through the twin with the
    counters zeroed just before:
    a. write uint8 shards (``{train,val}_{x,y}.npy``, NHWC) from the
       learnable stand-in ``synthetic_imagenet_like`` into a temporary
       directory: 320 train and 200 val images stored at 256x256 (~102 MB),
       and 96 + 32 stored at 224x224;
    b. ResNet-50 at its published widths and the JAX trainer's recipe
       (batch 32, 224x224) on the 256x256 shards for one epoch of 10
       steps: RandomResizedCrop + flip in numpy on the host (the numpy
       pipeline, ``--num-workers 0``, in series with the steps), the whole val
       split evaluated in batches of 64 (a ragged last batch of 8), a
       checkpoint; the loss finite, 200 images counted, kernels 1, 3 and 4
       as the run implies; the host milliseconds of each batch's
       transform, the step times and the evaluation's reported apart;
    c. 3 steps each of ``--no-augment`` on the 256x256 shards (Resize +
       CenterCrop) and on the 224x224 shards (pass-through);
    d. ``examples/evaluate.py --checkpoint-dir`` on 18b's checkpoint and
       ``--init-from-torch`` on a torchvision-format ``{'model': ...}``
       file of the same weights each reproduce 18b's validation loss and
       accuracy within ``RESUME_RTOL`` (18b and 18d with deterministic
       cuDNN); the twin started with ``--init-from-torch`` holds the file's
       weights bitwise; kernel 1 at ResNet-50's 53 convs on a batch of the
       shard path, as in phase 3;
19. the WikiText RNN trainer and the tied head:
    a. kernels 3 (the decoder's [1000, 651] group) and 4 (the LSTM's
       leaves, momentum 0) at the path's shapes, as in phase 7; then the
       WikiText twin at the JAX recipe's widths (2-layer LSTM 650 wide,
       dropout 0.5, batch 20, BPTT 35, lr 20, clip 0.25, K-FAC every 10
       steps) on the synthetic corpus (vocab 1,000) for 30 steps and one
       validation pass: the loss finite and falling, kernels 3 and 4 as
       implied, the first 5 losses within 1e-3 of ``--apply-kernel dense``
       (the same dropout masks: one generator seed); one capture window
       profiled (recurrences, GEMMs, kernels 3 and 4, the idle share);
    b. token files with WikiText-2's vocabulary of 33,278 words, passed
       with ``--data-dir``: 3 steps (a refresh: one eigh of the 33,278²
       G factor, wider than cuSOLVER's ``syevd`` takes: the spectral split
       of ``ops/eigh.py``; 2 capture steps), the loss finite, the refresh
       and capture step times and the peak memory; kernel 3 on the
       refresh's 33,278-wide eigenbasis within 1e-4 of its plain version;
       the refresh's decomposition held to the factor it decomposed, in
       float64 on 256 random directions (reconstruction and orthogonality
       within 1e-5);
    c. ``--tied --kfac-embedding`` (the reduce lens; kernel 2 once per
       capture step, kernel 3 never: no dense layer is left) for 10 steps,
       its first 5 losses within 1e-3 of ``--apply-kernel dense``; kernel 2
       on the path's [20, 35] ids as in phase 7; ``--model GRU`` and
       ``RNN_TANH``, 5 steps each; a checkpoint and epoch 1 resumed from
       it within ``RESUME_RTOL`` (deterministic cuDNN);
    d. the transformer LM at the LM path's widths cut to 2 layers with
       ``--tie-embeddings --kfac-embedding`` for 5 steps, counters as
       implied, the first 5 losses within 1e-3 of its oracle path; and on a
       written WikiText corpus (``--data-dir``) for 2 steps;
20. the native loader and the distributed K-FAC:
    a. the native loader (``runtime/loader.py``): its pass-through batches
       bitwise equal to the numpy pipeline's, its RandomResizedCrop batches
       bitwise equal on 1 and 4 threads; the host milliseconds of one batch
       of 32 through ``native_transform``; 18b's ResNet-50 on the shards run
       again with ``--num-workers 4``, counters zeroed and gated: images/s
       with the loader overlapping the steps, beside 18b's numpy pipeline
       in series;
    b. after ``torch.cuda.device_count()`` on a line of its own, the CIFAR
       twin (ResNet-32, 30 steps) through ``launch.initialize`` on NCCL at
       world size 1 (``torchrun``'s variables set): its losses within
       ``RESUME_RTOL`` of the non-distributed run's (both with
       deterministic cuDNN), counters as implied;
    c. two ranks on the one card (spawned processes, a file store, gloo
       over CUDA tensors; the ranks of 20c, 21e, 22b-c, 23b-d, 24d, 25c,
       26b, 27c and 29b run ahead in one pool of two processes,
       ``rank_pool``, each job with its own store and counters, and each
       phase gates its job's results in its place; the pool's seconds per
       job are printed), ResNet-32 with ``--distribute-precondition`` for
       ``TWO_RANK_DEPTH`` (6) steps: kernels 1, 3 (on each rank's shape groups) and 4 launch in
       each rank as implied; the sharded refresh's factors within 1e-5 and
       the distributed apply's updates within 1e-6 of the replicated ones;
       the first 5 losses within 1e-3 of one process on the concatenated
       batch; the collectives' host milliseconds per refresh and per capture
       step from ``torch.profiler``;
    d. float32 ``syevd`` of an EMA-like factor at n = 26,733, cuSOLVER's
       limit (the closed watch item's widest width), through the port's
       route (``ops/eigh.py``), held to 1e-5 in reconstruction and
       orthogonality, in float64 on 256 random directions;
21. the pipelined refresh and the truncated solvers (slice 12):
    a. ResNet-32 through the CIFAR twin (phase 4's recipe): ``--eigh-chunks
       1`` gives 30 losses bitwise equal to the run without it
       (deterministic cuDNN); ``--eigh-chunks 5`` for 30 steps: a
       monolithic bootstrap, then chunk steps with the swap on the 5th,
       the loss finite and falling, kernels 1, 3 and 4 as implied, the
       chunk step's median ms beside the capture and refresh steps'; on
       the run's last factors, frozen, a chunked pass's swapped basis
       within 1e-5 (reconstructions) of a monolithic refresh;
    b. the LM twin at phases 7-10's widths with ``--solver rsvd`` (rank
       128, sides from 512 truncated), 38 steps: kernels 2 and 4-7 as
       implied and kernel 3 only on groups without a truncated side, the
       first 5 losses within 1e-3 of ``--apply-kernel dense``, the refresh
       step's median ms beside phase 8's and the spectrum mass; one
       refresh step of each solver profiled (device time by group, idle);
    c. WikiText-2's vocabulary (19b's corpus) with ``--solver rsvd``, 3
       steps: the refresh step's ms and peak memory beside 19b's, the
       truncated G basis of the 33,278-wide factor orthonormal within 1e-5
       in float64 on 256 random directions, the spectrum mass, the capture
       step's ms;
    d. the WikiText LSTM (19a's recipe) with ``--solver streaming``, 30
       steps: at most 3 re-orthonormalizations, the fold step's median ms
       beside 19a's capture step's, the residual gauge at each boundary;
       5 steps with ``--stream-drift-threshold 0 --kfac-update-freq 1``
       bitwise equal to ``--solver rsvd`` (when two rsvd runs are);
    e. two ranks on the one card (20c's setup), ResNet-32 with
       ``--eigh-chunks 2 --solver rsvd --solver-auto-threshold 256
       --kfac-update-freq 4``, 6 steps (a chunk and its swap at 4 and 5):
       kernels 1, 3 and 4 as implied per rank, the sharded
       rank-aware refresh and a sharded chunked pass within 1e-5 of the
       replicated refresh, the first 5 losses within 1e-3 of one process
       on the concatenated batch;
22. the factor comm plane and the LM twins across ranks (slice 13):
    a. the LM twin at phases 7-10's widths through ``launch.initialize`` on
       NCCL at world size 1 (20b's setup) with ``--factor-comm-dtype bf16
       --factor-comm-freq 2 --grad-comm-dtype bf16`` (inert at world 1, as
       in the JAX package), phase 8's 38 steps: its losses within
       ``RESUME_RTOL`` of phase 8's, kernels 2 and 3-7 as implied, the
       capture step's median ms beside phase 8's and 20b's;
    b. two ranks on the one card (20c's setup), the LM for 6 steps with
       ``--factor-comm-freq 2`` on the float32 wire and again with the bf16
       factor and gradient wires: kernels 2 and 3-7 per rank as implied;
       the f32-wire run's first 5 losses within 1e-3 of one process on the
       concatenated batch, the bf16 run's 6 within ``COMM_BF16_RTOL`` of
       it, its factor wire bytes half the f32 run's; after every flush the
       two ranks' factors and parameters bitwise equal (their digests);
       the collectives' host
       ms per capture and per flush step from ``torch.profiler``; the CIFAR
       twin (ResNet-32, phase 4's recipe) with the bf16 wires and
       ``--factor-comm-freq 2`` for 6 steps through its ``main()``:
       kernels 1, 3 and 4 per rank as implied, flush steps among them;
    c. in the same two ranks, the WikiText LSTM (19a's recipe) for 6 steps
       with ``--factor-comm-dtype int8 --factor-comm-freq 4`` and on the
       float32 wire: kernels 3 and 4 per rank as implied, the int8 wire's
       bytes (``quant_wire_bytes``, ~0.51x bf16), the error-feedback
       residual's norm at each flush within 16/127 of the factors' (one
       quantization step per element), the 6 losses within
       ``COMM_INT8_RTOL`` of the f32 wire's, the ranks' factors and
       parameters bitwise equal after every flush; then, in this process on
       NCCL at world size 1, a whole int8 flush merge of a 33,278²-element
       G factor (WikiText-2's): its peak memory above the factor and its
       residual, and its time;
23. owner-sharded factor state and the overlap plane (slice 14):
    a. ``--factor-sharding owner --comm-overlap`` through ``launch.initialize``
       on NCCL at world size 1: the CIFAR twin (ResNet-32, 12 steps,
       deterministic cuDNN) against the same run without a group, the LM
       twin against phase 8's 38 steps; both levers warn and are inert, the
       losses within ``RESUME_RTOL``, kernels 1-7 as implied;
    b. two ranks on the one card (20c's setup): ResNet-32 owner-sharded for
       6 steps (a refresh included): kernels 1, 3 (once per step per owned
       shape group of dense "update" layers) and 4 per rank as the plan
       implies, the parameters' digests equal on both ranks after every
       step, the first 5 losses within 1e-3 of one process on the
       concatenated batch, a capture and a refresh step each issuing one
       reduce-scatter per wire bucket and one all-gather inside
       ``KFAC.update`` and nothing else; the LM owner-sharded with the bf16
       factor wire deferred to every second capture step, with and without
       ``--comm-overlap``, and replicated with the same wires: kernels 2-7
       per rank as implied, overlap on and off bitwise equal, the owner run
       within 1e-3 of the replicated one, step medians by kind and the
       collectives' host ms per capture and flush step; the LM replicated
       with the bf16 wire on every capture step, serial and with
       ``--comm-overlap`` (the bucket means started before the gradient
       mean, which owner-sharded and deferred runs do not have): bitwise
       equal losses, capture-step medians;
    c. in the same two ranks, the WikiText LSTM (19a's recipe, dropout 0,
       ``--kfac-embedding``) owner-sharded with ``--eigh-chunks 2 --solver
       rsvd --solver-auto-threshold 256``, with and without
       ``--comm-overlap``: kernels 2-4 per rank as implied, a two-chunk owner
       pass within ``EIGH_TOL`` (reconstructions) of the monolithic owner
       refresh, the losses within 1e-3 of one process on the concatenated
       batch and overlap within ``RESUME_RTOL``;
    d. on the LM's owner ranks: the K-FAC state's bytes and
       ``memory_allocated`` at init, owner against replicated, beside the
       plan's ``total_buffer_local`` and ``replicated_total``; an owner
       checkpoint saved and restored on the two ranks (every shard row's
       digest equal) and a replicated one re-homed; on the host only,
       ``shard_plan_bytes`` of the WikiText-2 LSTM (33,278-word decoder and
       embedding) for 2, 4 and 8 ranks;
    e. every kernel's launches on phase 23's paths, per rank on the
       two-rank ones, into the kernels line;
24. the LM's extras and sequence parallelism (slice 15): a. phase 8's
    recipe with ``--qkv-lens``; b. ``--remat`` and dropout, the remat
    memory figures; c. flash backward against float64 at T = 4096, 8192
    and 16384 (D 64 and 128), each of dQ, dK and dV within 1e-4 of the
    largest entry, beside the plain float32 version's own error; dK/dV
    also as one chunk (its error and both times) and repeated bitwise;
    ``flash_dkv``'s spill bytes no more than run AG's; d. two ranks on the
    one card under ``--seq-parallel 2``, ring and Ulysses, 6 steps with
    ``--kfac-update-freq 4`` (a refresh at 0 and 4); e. every kernel's
    launches on these paths;
25. the shard lenses and the data×tensor world (slice 16), each path with
    the counters zeroed just before it:
    a. phase 8's recipe with ``--moe-experts 4`` for one epoch through the
       twin: the loss finite and falling, kernel 2 five times per capture
       step (the embedding and the 4 MoE banks' expert fractions) and
       kernels 3-7 as phase 8 has them, the first ``ORACLE_STEPS`` losses
       within 1e-3 of the oracle path one step at a time
       (``one_step_oracle``), the capture and refresh step medians beside
       phase 8's, the experts that received no token at the last capture
       step; kernel 2 on the last capture step's expert ids (vocab 4)
       bitwise equal to its plain version, timed against
       ``torch.bincount`` and its bound (its own row of the kernels line);
    b. the ``tensor_parallel=2`` lens model (``ff1#c2``, ``ff2#r2``) at the
       same widths on one process through ``KFAC``/``make_train_step``:
       the stacks' shapes (``[2, 1024, 1024]`` for ff1's G and ff2's A),
       kernels 2-7 as implied (kernel 3 on the 3 dense shape groups only),
       the one-step oracle, refresh and capture step medians;
    c. ``--tensor-parallel 2 --moe-experts 4`` on two ranks of the one card
       over gloo (a data×tensor world of one data slot): kernels 2-7 per
       rank as implied, the parameters' digests and the losses equal on
       both ranks after every step, the losses within float32 rounding
       (``TP_RTOL``) of one process;
26. the 3-D data×fsdp×tensor world (slice 17), each path with the
    counters zeroed just before it:
    a. the LM twin with ``--fsdp 1 --tensor-parallel 1`` (the 3-D world of
       one rank) through ``launch.initialize`` on NCCL at world size 1,
       phase 8's 38 steps: every loss bitwise phase 8's, kernels 2-7 as
       implied;
    b. ``--fsdp 1 --tensor-parallel 2`` at phase 8's widths on two ranks of
       the one card over gloo (12 steps): each rank computes with its
       shards of ff1 (column) and ff2 (row) and keeps their K-FAC blocks
       (``[1, 1024, 1024]``); kernels 2-7 per rank as implied, the ranks'
       losses equal and within ``TP_RTOL`` of 25b's one-process lens
       model, capture and refresh medians, and per rank the bytes of the
       MLP weights, their momentum and the G/A stacks beside 25b's;
    c. ``--fsdp 2 --tensor-parallel 2 --n-layers 2`` on four ranks of the
       one card over gloo (6 steps): kernels 2-7 per rank as implied, the
       ranks' losses within ``TP_RTOL`` of each other and of one process
       (the lens model at the global batch of 8), the fsdp parts 1/2 of
       the parameters the JAX rule splits; on rank 0's SGD leaves (its
       fsdp parts, its tensor shards, the whole small leaves) kernel 4
       bitwise equal to its plain version, timed against
       ``torch.optim.SGD`` and its bound (its own row of the kernels line);
27. telemetry, the profiler hook and the planner (slice 18), each path
    with the counters zeroed just before it:
    a. ResNet-32 through the twin, ``TELEMETRY_STEPS`` steps of the
       recipe's cadence (refreshes at 0 and 10), with deterministic cuDNN,
       four times in turns: plain, with ``--telemetry-dir --profile
       safe``, with those and ``--profile-epoch 0 --log-dir``, and plain
       again: the losses and the launch counters of kernels 1, 3 and 4
       bitwise equal across the four;
       ``metrics.prom`` and ``telemetry.jsonl`` hold only the names
       docs/OBSERVABILITY.md registers; the ``step/factors`` and
       ``step/eigen`` medians beside the twin's own host-clock step
       medians; the capture-step overhead of telemetry; the Chrome trace
       names kernels 1, 3 and 4, as many launches of each as the counters
       imply (kernel 3: four device launches a call, ``TRACE_KERNELS``),
       its epoch traced between spin guards (the profiler drops device
       events at a region's edges; again, up to ``PROFILE_ATTEMPTS`` runs,
       while it dropped a guard);
    b. ``--profile production --autotune-steps 2`` on ResNet-32 and on the
       LM (phase 8's model, ``TELEMETRY_STEPS`` steps): the resolved plan,
       the dropped rules, the autotune candidates with their card times and
       the winner, the losses finite; then the resolved plan without
       autotune and its drift gauge: the refresh time the cost model
       predicts (its MACs over a dense MACs-per-ms rate measured on the same
       path's safe run) against the measured one (the LM with
       ``--stream-drift-threshold 0``: a re-orthonormalization at step 10);
    c. two ranks of the one card over gloo, the CIFAR twin with
       ``--telemetry-dir`` (6 steps, ``--kfac-update-freq 4``): the
       rank-aware summary table counts each span's samples of both ranks,
       and the wire-bytes drift of the live factor comm plane;
28. the elastic runtime (slice 19), on a written CIFAR-format set, with
    deterministic cuDNN, each path with the counters zeroed just before it
    and its launches held to what the steps that ran imply (a resumed run
    counts only its own):
    a. ResNet-32 through the CIFAR twin (``ELASTIC_CIFAR_FLAGS``: 2 epochs
       of 8 steps, ``--kfac-update-freq 4 --eigh-chunks 3``,
       ``--snapshot-every 4``): uninterrupted; in a subprocess killed by
       ``KFAC_FAULT_KILL_AT_STEP=6 KFAC_FAULT_KILL_MODE=exit`` (rc 75, the
       newest complete snapshot ``snap-4``, its launches read just before
       the kill) and rerun: resumed at step 4, every later loss bitwise the
       uninterrupted run's; killed in signal mode at step 6 (the emergency
       ``snap-6``, chunks 0 and 1 landed) and resumed bitwise across the
       epoch boundary at 8; the snapshots' blocking and write medians, the
       restores, the payload's bytes and the capture step's median; then
       the WikiText LSTM at small widths (dropout 0.5), killed in signal
       mode mid-epoch at step 4 and resumed bitwise;
    b. the LM at phase 8's widths, 12 steps, ``--snapshot-every 5``: killed
       in signal mode at step 7 and resumed bitwise; the payload's bytes,
       the blocking and total snapshot times, the restore, and the overhead
       ratio ``snapshot_duration_ms / (10 × step_ms)``;
    c. two ranks of the one card over gloo, the CIFAR twin with
       ``--factor-sharding owner --factor-comm-freq 3 --kfac-update-freq
       4``: killed in signal mode at step 6 (``factor_sync_age`` 1,
       ``packed_world`` 2) and resumed on two fresh ranks, each rank's
       losses and every tensor of the state at step 12 bitwise the
       uninterrupted ranks'; on one process (the owner mode runs
       replicated) the same snapshot through the 2 -> 1 resize replan
       (``kfac/replan_count`` 1; every factor and basis carried bitwise
       from its slots' rows, the unflushed accumulators dropped) and on
       through the refresh at step 8 to step 12, its parameters within
       ``ELASTIC_RESIZE_TOL`` of the replicated continuation of the state
       the resize resumed;
29. the curvature service (slice 20), with deterministic cuDNN, each path
    with the counters zeroed just before it:
    a. in process (``CurvatureService``, the worker a thread refreshing on
       a CUDA stream of its own on the same card): ResNet-32 at batch 128,
       ``--kfac-update-freq 10 --kfac-cov-update-freq 2``, 30 steps at
       staleness 0: every step's parameters equal (bitwise, or within
       ``SERVICE_RTOL`` relative, reported) to the inline schedule whose
       refresh runs at boundary + 1 (a step that captures nothing); 0
       ``torch.linalg.eigh`` calls on the trainer's thread, one refresh per
       boundary on the worker's; kernels 1, 3 and 4 as implied. Then at the
       recipe's cadence (``--kfac-cov-update-freq 1``) ResNet-32 (30 steps)
       and the LM at phase 8's widths (12 steps), each inline and through
       the service at staleness 0 and 1: the median, p95 and max of the
       capture, boundary and after-boundary step times, the worker's
       refresh, the publish and install times and the deadline waits;
    b. two ranks of the one card over gloo, rank 1 the worker
       (``--service-devices 1``): the CIFAR twin (ResNet-32, 12 steps,
       ``--kfac-update-freq 4``) and the LM twin (phase 8's widths, 12
       steps): finite losses, 0 eigh calls on the trainer rank, one refresh
       per boundary on the worker, every basis installed by boundary + 1,
       the trainer's launches of kernels 1, 3, 4 (CIFAR) and 2-7 (LM) as
       implied; the publish (npz write) and install times;
30. the compiled step (slice 22), with deterministic cuDNN: the CIFAR
    twin's ResNet-32 recipe on a written CIFAR-format set (``COMPILED_*``:
    2 epochs of 20 steps, the lr warmup changing the rate every step,
    ``--damping-schedule 1`` stepping the damping at epoch 1,
    ``--kfac-diagnostics``), run graphed (the twin's
    ``GraphedTrainStep``) and eager (``eager_step_reason`` patched) from
    the same seed, each with the counters zeroed just before: every loss,
    and in the last checkpoint every parameter, BatchNorm statistic,
    momentum and K-FAC state tensor, bitwise equal (else the largest
    difference, held to ``COMPILED_RTOL``); the captured graphs equal to
    ``compile_cache.expected_step_variants`` less the variants run eagerly
    by rule; ``compile/retraces`` 0; every launch counter equal to the
    eager run's; each variant's capture ms and the step medians by kind;
    and the capture window's device idle share both ways (steps 2-9 of the
    ResNet-32 path, ``torch.profiler``);
31. the compiled step on the LM and ImageNet twins (slice 23), with
    deterministic cuDNN: (a) the LM twin at phase 8's widths, its recipe
    (``LM_GRAPH_RUNS``: 2 epochs of 10 steps, refreshes at 0 and 10,
    ``--kfac-diagnostics``) and ``--remat``, ``--qkv-lens``,
    ``--moe-experts 4`` and ``--solver streaming`` (boundaries every 3
    steps) over 6 steps each; (b) the ImageNet twin on ResNeXt-50 32x4d at
    batch 32, 224x224 (``IMAGENET_GRAPH_RUNS``: 2 epochs of 6 steps with
    ``--diag-warmup 1``, then ``--bf16``, ``--batches-per-allreduce 2`` and
    ``--kfac-update-freq 0`` over 6 steps each); each run graphed and
    eager (the twin's ``eager_step_reason`` patched) from the same seed,
    each with the counters zeroed just before: every loss and every tensor
    of the last checkpoint bitwise equal; every launch counter equal both
    ways, and each kernel of the path (kernels 2-7 on the LM; 1, 1g, 3, 4
    on ResNeXt, the bf16 routes under ``--bf16``) launched inside the
    replays; the graphs and the variants run eagerly (only those of
    ``EAGER_VARIANTS``) within ``compile_cache.expected_step_variants``;
    on the LM ``compile/retraces`` 0; each variant's capture ms and
    launches per replay, and the step medians by kind; (c) the capture
    window (steps 2-9) of the LM and ResNeXt-50 paths, graphed and eager
    (``torch.profiler``): wall and busy ms per step and the idle share;
32. print one ``{"phase_seconds": {...}}`` line (each phase's seconds,
    from its mark to the next), then one ``{"kernels": [...]}`` line (eight kernels and the bf16 routes
    of 1, 1g and 3, and kernel 2 as the MoE dispatch; kernel 1's ResNet-50
    row, kernel 2's tied-path row, kernel 3's WikiText rows and kernel 4's
    LSTM and 3-D rows beside the others, the two-rank launches of kernels
    1, 3 and 4, and every kernel's launches on phase 21's to 31's paths,
    per rank on the multi-rank ones), then the last line ``{"ok": true,
    "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# float32 outside the tensor cores, TF32 on the tensor cores, and HBM3
# bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

BATCH = 128
STEPS = 30
MODEL = "resnet32"
TIMING_REPS = 20
RESNET_ARGS = [
    "--synthetic", "--model", MODEL, "--batch-size", str(BATCH), "--epochs", "1",
    "--seed", "0", "--device", "cuda",
]

# The LM path: the embed-kfac configuration (d_model 512, 8 heads, 4 layers,
# T 2048, batch 4, K-FAC token embedding) through the trainer twin, whose
# other flags keep the JAX trainer's defaults.
LM_ARGS = [
    "--synthetic", "--d-model", "512", "--n-heads", "8", "--n-layers", "4",
    "--seq-len", "2048", "--batch-size", "4", "--kfac-embedding",
    "--seed", "0", "--device", "cuda",
]
LM_EPOCHS = 2
ORACLE_STEPS = 5

# The ImageNet path: ResNeXt-50 32x4d at its published widths and depth and
# the JAX trainer's per-device recipe (batch 32, 224x224, lr 0.0125,
# momentum 0.9, wd 5e-5, label smoothing 0.1, damping 0.002, stat-decay 0.95,
# kl-clip 0.001, kfac-update-freq 10, cov-freq 1, diag-blocks 1,
# diag-warmup 5), all trainer defaults but the model and the step count.
IMAGENET_MODEL = "resnext50_32x4d"
IMAGENET_BATCH = 32
IMAGENET_STEPS = 30
IMAGENET_ARGS = [
    "--synthetic", "--model", IMAGENET_MODEL, "--batch-size", str(IMAGENET_BATCH),
    "--image-size", "224", "--epochs", "1", "--seed", "0", "--device", "cuda",
]


# The CIFAR-10 path with data: a set in the cifar-10-batches-py layout,
# written from the learnable stand-in (five train batches of 1280 images and
# a test batch of 2000, cut from 50,000 / 10,000), trained through the twin
# at the BASELINE.md recipe (its defaults): 2 epochs of 50 steps of 128.
CIFAR_PER_BATCH = 1280
CIFAR_TEST = 2000
CIFAR_EPOCHS = 2
CIFAR_STEPS = 5 * CIFAR_PER_BATCH // BATCH
CIFAR_FLAGS = ["--kfac-diagnostics", "--bn-recal-batches", "5"]
# tags of scalars.jsonl: the JAX trainer's, --kfac-diagnostics included
CIFAR_TAGS = {
    "train/loss", "train/accuracy", "train/lr", "val/loss", "val/accuracy",
    "kfac/nu_min", "kfac/nu_mean", "kfac/min_damped_eig", "kfac/max_damped_eig_mean",
    "kfac/cond_max_mean", "kfac/grad_norm_mean", "kfac/update_norm_mean",
    "kfac/update_grad_cos_mean", "kfac/eigen_stale_steps_mean",
}
# Resume tolerance, relative. Phases 16b and 16c run with deterministic
# cuDNN, and kernels 1, 3 and 4 are bitwise repeatable, so an epoch resumed
# from a checkpoint repeats the uninterrupted run's epoch; a lost or stale
# piece of state would show at the first step and grow from there.
RESUME_RTOL = 1e-6

# The bf16 modes (phases 17a-b): bfloat16 compute and eigenvectors, the JAX
# image trainers' --bf16 --eigen-dtype bf16.
BF16_FLAGS = ["--bf16", "--eigen-dtype", "bf16"]
# Kernel path against the "dense" oracle in the bf16 modes, relative, per
# step (each oracle step from the kernel path's state): the two paths'
# parameters differ by float32 rounding, which flips the bfloat16 rounding
# of some weights and activations of the next forward (a step of 2^-8 each)
# and, as in float32, cuDNN's bf16 convolutions differ from run to run; 1e-2
# is ~2.5 bf16 steps of the loss.
BF16_ORACLE_RTOL = 1e-2
# --precond-precision default (one TF32 pass in the dense rotations) against
# IEEE float32 (device.rotation_precision): the preconditioned gradients'
# largest difference over their largest entry, per layer, and the first 10
# losses of the inverse method, relative.
PRECISION_RTOL = 1e-2

# The twins' bookkeeping (phase 17d), cut in depth and steps to keep the
# script near 4 minutes: the ImageNet twin on ResNet-18 at 64x64 (the
# ResNeXt-50 recipe's other flags) for epochs of 4 steps, the LM twin at the
# LM path's widths for 2 epochs of 3 steps.
IMAGENET_BOOK_ARGS = [
    "--synthetic", "--model", "resnet18", "--batch-size", "32", "--image-size", "64",
    "--seed", "0", "--device", "cuda",
]
BOOK_STEPS = 4
LM_BOOK_STEPS = 3


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_ATTEMPTS = 3


def spin_guard():
    """Spin kernels (``spin_kernel``) that open and close every profiled
    region: 2000 short ones, then ~25 ms of long ones. The profiler drops
    device events at a region's edges: unguarded, the last fused-SGD launch
    of the LM window and ~700 events around it; behind 20 short spins, or
    behind 0.1 s of 50 long ones, some or all of the guard itself."""
    import torch

    for _ in range(2000):
        torch.cuda._sleep(1000)
    for _ in range(10):
        torch.cuda._sleep(4_000_000)


def guarded_profile(body):
    """``(device events, body's result)`` of ``body()`` run under
    ``torch.profiler`` between two :func:`spin_guard` s: ``[(start ns, end
    ns, name), ...]`` in device order, the guards left out. Runs ``body``
    again, up to ``PROFILE_ATTEMPTS`` times in all, while the trace has lost
    a whole guard (then the region's own events at that edge may be gone
    too)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            spin_guard()
            torch.cuda.synchronize()
            result = body()
            torch.cuda.synchronize()
            spin_guard()
            torch.cuda.synchronize()
        # device-side events only (kernels, copies, memsets), read from the
        # raw trace: prof.events() builds a tree of every event, which takes
        # minutes at ResNeXt's ~10^4 launches per step
        events = sorted((e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA)
        spin = ["spin_kernel" in name for _, _, name in events]
        if events and spin[0] and spin[-1]:
            return [e for e, is_spin in zip(events, spin) if not is_spin], result
    raise AssertionError(f"torch.profiler lost an edge guard of a profiled region {PROFILE_ATTEMPTS} times")


def kernel_spans(fn, fragment, reps=TIMING_REPS, flush=None):
    """``(device ms per call, launches per call, other device events per
    call)`` of ``fn`` from ``torch.profiler``'s kernel spans: the device
    events whose name holds ``fragment`` are ``fn``'s kernel; every other
    device event (a memset, a copy, another kernel) is counted apart.
    ``flush`` (a tensor over 50 MB) is zeroed before each call, so that the
    kernel finds the L2 cache cold, as a training step leaves it; its one
    fill kernel per call is not counted."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()

    events, _ = guarded_profile(calls)
    ms, launches, other = 0.0, 0, 0
    for start, end, name in events:
        if fragment in name:
            ms += (end - start) / 1e6
            launches += 1
        else:
            other += 1
    if flush is not None:
        other -= reps
    return ms / reps, launches / reps, other / reps


def device_spans(fn, fragment):
    """A kernel row's device time beside its wall time: the profiler's
    kernel spans per call of ``fn`` (:func:`kernel_spans`, L2 warm, back
    to back), its launches and the other device events per call."""
    ms, launches, other = kernel_spans(fn, fragment)
    if not launches:
        raise AssertionError(f"no device kernel named *{fragment}* in the profile of its row")
    return {"device_ms": ms, "device_ms_is": "profiler kernel spans per call, L2 warm",
            "device_launches_per_call": launches, "device_other_events_per_call": other}


def bound_ms(calls, tf32_products=0, bf16=False):
    """Least time for ``[(bytes, flops), ...]`` calls: per call the larger of
    bytes over the memory rate and FLOPs over the float32 peak, summed; with
    ``tf32_products=n``, FLOPs taken as n TF32 products on the tensor cores
    (3xTF32: n = 3; the bf16-Q apply: n = 2) over the TF32 peak instead;
    with ``bf16``, as one bf16 product each over the bf16 peak."""
    def t_ops(f):
        if bf16:
            return f / PEAK_BF16_FLOPS
        return f * tf32_products / PEAK_TF32_FLOPS if tf32_products else f / PEAK_F32_FLOPS

    t_bytes = sum(b / PEAK_BYTES for b, _ in calls)
    t_flops = sum(t_ops(f) for _, f in calls)
    total = sum(max(b / PEAK_BYTES, t_ops(f)) for b, f in calls)
    return total * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def scaled_err(got, want):
    """``(max |got − want|, that over max |want|)``."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def conv_inputs(model, images, grouped):
    """``(x, kernel_size, strides, padding, has_bias, dilation, groups)`` of
    every ungrouped (``grouped=False``) or grouped conv of one forward."""
    import torch

    from kfac_pytorch_tpu_torch.models.layers import KFACConv

    calls = []
    hooks = [
        m.register_forward_pre_hook(
            lambda mod, inp: calls.append(
                (inp[0].detach().contiguous(), mod.kernel_size, mod.stride,
                 mod.factor_padding(), mod.bias is not None, mod.dilation, mod.groups)
            )
        )
        for m in model.modules() if isinstance(m, KFACConv) and (m.groups > 1) == grouped
    ]
    with torch.no_grad():
        model(images)
    for h in hooks:
        h.remove()
    return calls


def conv_work(x, groups, ks, st, pad, bias):
    """``(bytes, flops)`` of one conv's A factors: the input read once (in
    its own type) and the float32 ``[G, a, a]`` output written once; per
    group ``a·(a+1)/2`` distinct sums of ``rows`` products."""
    a = x.shape[1] // groups * ks[0] * ks[1] + int(bias)
    h_out = (x.shape[2] + 2 * pad[0][0] - ks[0]) // st[0] + 1
    w_out = (x.shape[3] + 2 * pad[1][0] - ks[1]) // st[1] + 1
    rows = x.shape[0] * h_out * w_out
    return x.element_size() * x.numel() + 4 * groups * a * a, groups * rows * a * (a + 1)


def conv_kernel_checks(calls, grouped):
    """Kernel 1 (``grouped=False``) or 1g on every ``(x, groups, ks, st,
    pad, bias, dil)`` of ``calls``: within 1e-5 of the largest plain entry
    per layer and two launches bitwise equal. Returns the worst errors, the
    route's bound (3xTF32 for float32 inputs, one bf16 MMA per product for
    bfloat16 ones) and the float32 bound, and the five costliest geometries
    (time per step: every layer of that geometry timed) with their route."""
    import torch

    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk

    bf16 = calls[0][0].dtype == torch.bfloat16
    route = dict(bf16=True) if bf16 else dict(tf32_products=3)

    def kernel(c):
        return fk.compute_a_conv_grouped_fused(*c) if grouped else fk.compute_a_conv_fused(c[0], *c[2:])

    def plain(c):
        return (fk.compute_a_conv_grouped_fused_plain(*c) if grouped
                else fk.compute_a_conv_fused_plain(c[0], *c[2:]))

    tol = 1e-5
    worst_abs = worst_rel = 0.0
    geometries = {}
    for c in calls:
        got = kernel(c)
        err, rel = scaled_err(got, plain(c))
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if not torch.equal(got, kernel(c)):
            raise AssertionError(f"conv A kernel: two launches differ at {tuple(c[0].shape)} {c[1:4]}")
        key = (tuple(c[0].shape), c[1], tuple(c[2]), tuple(c[3]))
        geometries.setdefault(key, []).append(c)
    if not worst_rel <= tol:
        raise AssertionError(f"conv A kernel{' 1g' * grouped} disagrees with its plain version: "
                             f"rel {worst_rel:.3e} > {tol}")
    per_geometry = []
    for (shape, groups, ks, st), cs in geometries.items():
        c = cs[0]
        per_geometry.append({
            "geometry": f"x {list(shape)}, G {groups}, {ks[0]}x{ks[1]} stride {st[0]}",
            "layers": len(cs),
            "route": fk.patch_cov_route(*c),
            "ms": time_ms(lambda: [kernel(c) for c in cs]),
            "bound_ms": bound_ms([conv_work(*c[:6])] * len(cs), **route)[0],
        })
    work = [conv_work(*c[:6]) for c in calls]
    tc = bound_ms(work, **route)
    return {
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "tolerance": f"|kernel - plain| <= {tol} * max|plain| per layer",
        "repeat_bitwise_equal": True,
        "ms": time_ms(lambda: [kernel(c) for c in calls]),
        **device_spans(lambda: [kernel(c) for c in calls], "patch_cov"),
        "bound_ms": tc[0],
        "bound_by": tc[1],
        "bound_route": ("one bf16 MMA per product: FLOPs / 989 TFLOP/s, bf16 input bytes" if bf16
                        else "3xTF32 on the tensor cores: 3 x FLOPs / 495 TFLOP/s"),
        "bound_f32_cuda_core_ms": bound_ms(work)[0],
        "costliest_geometries": sorted(per_geometry, key=lambda r: -r["ms"])[:5],
    }


def conv_a_phase(model, images, bf16=False):
    """Kernel 1 on every ungrouped conv input of one forward (ResNet-32 at
    batch 128, or ResNeXt-50's 37 ungrouped convs at batch 32); with
    ``bf16``, its bf16 route on the inputs of a bfloat16 model's forward
    (the stem's float32 batch cast too, so that every geometry is held)."""
    import torch
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk

    calls = [(c[0].to(torch.bfloat16) if bf16 else c[0], 1, *c[1:6])
             for c in conv_inputs(model, images, grouped=False)]
    checks = conv_kernel_checks(calls, grouped=False)

    def library():
        for x, _, ks, st, pad, _, dil in calls:
            cols = F.unfold(x.float(), ks, dilation=dil, padding=pad[0][0], stride=st)
            p = cols.transpose(1, 2).reshape(-1, cols.shape[1])
            p.T @ p

    return {
        "name": "patch_cov bf16 (conv A factor, bf16 route)" if bf16 else "patch_cov (conv A factor)",
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/patch_cov.cu",
        "replaces": "kfac_pytorch_tpu/ops/factor_kernels.py:251",
        "unit": f"{len(calls)} conv A factors of one capture step"
                + (", bfloat16 activations" if bf16 else ""),
        **checks,
        "plain_ms": time_ms(lambda: [fk.compute_a_conv_fused_plain(c[0], *c[2:]) for c in calls]),
        "library_ms": time_ms(library),
        "library": "F.unfold + torch.matmul per conv" + (" on the upcast input" if bf16 else ""),
    }


def grouped_conv_a_phase(model, images, bf16=False):
    """Kernel 1g on every grouped conv input of one ResNeXt forward: one
    launch per layer for all its groups, held per layer to its plain
    version (kernel 1's plain version per channel slice, stacked); with
    ``bf16``, its bf16 route on a bfloat16 model's activations."""
    import torch

    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk

    calls = [(c[0], c[6], *c[1:6]) for c in conv_inputs(model, images, grouped=True)]
    assert all(c[0].dtype == (torch.bfloat16 if bf16 else torch.float32) for c in calls)
    checks = conv_kernel_checks(calls, grouped=True)
    kinds = sorted({c[0].shape[1] // c[1] for c in calls})

    def library():
        # one im2col of the whole input, viewed per group, one batched product
        for x, groups, ks, st, pad, _, dil in calls:
            cols = torch.nn.functional.unfold(x.float(), ks, dilation=dil, padding=pad[0][0], stride=st)
            b, f, L = cols.shape
            p = cols.view(b, groups, f // groups, L).permute(1, 0, 3, 2).reshape(groups, b * L, f // groups)
            torch.bmm(p.transpose(1, 2), p)

    return {
        "name": ("patch_cov grouped bf16 (grouped conv A factors, bf16 route)" if bf16
                 else "patch_cov grouped (grouped conv A factors)"),
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/patch_cov.cu",
        "replaces": "kfac_pytorch_tpu/ops/factor_kernels.py:251 (via compute_a_conv_grouped_fused :371)",
        "unit": f"{len(calls)} grouped convs of one capture step, G = {calls[0][1]}, C/G in {kinds}",
        **checks,
        # 512 im2col + matmul pairs per call: fewer repetitions
        "plain_ms": time_ms(lambda: [fk.compute_a_conv_grouped_fused_plain(*c) for c in calls], reps=5),
        "library_ms": time_ms(library),
        "library": "F.unfold of the whole input viewed [G, B*L, a] + torch.bmm per layer"
                   + (" (upcast input)" if bf16 else ""),
    }


def owned_update_shapes(kfac, facs, rank, world=2):
    """The layers ``rank`` solves through kernel 3 under
    ``--factor-sharding owner`` over ``world`` ranks (owned, "update"
    payload, no diagonal A), ``{name: (g, a)}`` in the model's order."""
    from kfac_pytorch_tpu_torch.ops import precondition as pc
    from kfac_pytorch_tpu_torch.parallel.assignment import plan_factor_shards

    shapes, diag = kfac._owner_shapes(facs)
    plan = plan_factor_shards(shapes, world, diag_a=diag)
    _, seg, _ = pc._owner_gather_layout(shapes, plan.owners, world, None, diag)
    return {n: v for n, v in shapes.items()
            if plan.owners[n] == rank and seg[n]["mode"] == "update" and n not in diag}


def apply_phase(model, device, q_dtype=None, owner_rank=None):
    """Kernel 3 on every shape group of ``model``'s K-FAC layers (diagonal-A
    embeddings stay out of the groups, as on the main path): within 1e-4
    of the largest plain entry per group (v and vg), two launches bitwise
    equal, timed for all groups together and per group (the five costliest
    groups are reported with the tile and copy widths they take). With
    ``q_dtype=torch.bfloat16``, its bf16-Q route: QA and QG stored in
    bfloat16 (the library yardstick multiplies by float32 copies of them).
    With ``owner_rank``, only the layers that rank solves on two ranks
    under ``--factor-sharding owner`` (:func:`owned_update_shapes`)."""
    import torch

    from kfac_pytorch_tpu_torch import KFAC, capture
    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import precondition as pc

    kfac = KFAC(layers=capture.discover_layers(model), device=device)
    facs = kfac._identity_factors(model)
    shapes = {n: (f["G"].shape[0], f["A"].shape[0]) for n, f in facs.items() if "A" in f}
    if owner_rank is not None:
        shapes = owned_update_shapes(kfac, facs, owner_rank)
    gen = torch.Generator(device=device).manual_seed(0)

    q_dtype = q_dtype or torch.float32
    bf16 = q_dtype == torch.bfloat16

    def orth(k, n):
        q, _ = torch.linalg.qr(torch.randn(k, n, n, device=device, generator=gen))
        return q.to(q_dtype).contiguous()

    groups = []
    for (g, a), names in pc.shape_groups(shapes).items():
        k = len(names)
        groups.append((
            torch.randn(k, g, a, device=device, generator=gen),
            orth(k, a),
            torch.rand(k, a, device=device, generator=gen) + 0.1,
            orth(k, g),
            torch.rand(k, g, device=device, generator=gen) + 0.1,
        ))
    lam = torch.full((), 0.003, device=device)
    tol = 1e-4
    worst_abs = worst_rel = 0.0
    group_rel = []
    for grp in groups:
        v, vg = ak.fused_precondition_stack(*grp, lam)
        v_p, vg_p = ak.fused_precondition_stack_plain(*grp, lam)
        rel = 0.0
        for got, want in ((v, v_p), (vg, vg_p)):
            err, r = scaled_err(got, want)
            worst_abs, worst_rel, rel = max(worst_abs, err), max(worst_rel, r), max(rel, r)
        group_rel.append(rel)
        again = ak.fused_precondition_stack(*grp, lam)
        if not (torch.equal(v, again[0]) and torch.equal(vg, again[1])):
            raise AssertionError(f"fused apply kernel: two launches differ at group {tuple(grp[0].shape)}")
    if not worst_rel <= tol:
        raise AssertionError(f"fused apply kernel disagrees with its plain version: rel {worst_rel:.3e} > {tol}")

    def library_one(gm, qa, da, qg, dg):
        t = torch.matmul(torch.matmul(qg.transpose(1, 2), gm), qa)
        t = t / (dg[:, :, None] * da[:, None, :] + lam)
        torch.matmul(torch.matmul(qg, t), qa.transpose(1, 2))

    # the yardstick's float32 copies of Q (made once, outside the timing)
    lib_groups = [(gm, qa.float(), da, qg.float(), dg) for gm, qa, da, qg, dg in groups]
    q_bytes = 2 if bf16 else 4
    products = 2 if bf16 else 3  # TF32 products per product

    def work(gm):
        k, g, a = gm.shape
        flops = k * (4 * g * a * (g + a) + 3 * g * a + 2 * g * a)
        nbytes = (4 * (2 * k * g * a + k * a + k * g + k + 1)
                  + q_bytes * (k * a * a + k * g * g))
        return nbytes, flops

    per_group = []
    for grp, lib, rel in zip(groups, lib_groups, group_rel):
        k, g, a = grp[0].shape
        per_group.append({
            "group": f"{k} x [{g}, {a}]",
            "route": ak.fused_apply_route(grp[0], grp[1], grp[3]),
            "ms": time_ms(lambda: ak.fused_precondition_stack(*grp, lam)),
            "library_ms": time_ms(lambda: library_one(*lib)),
            "bound_ms": bound_ms([work(grp[0])], tf32_products=products)[0],
            "max_rel_err": rel,
        })
    tc = bound_ms([work(grp[0]) for grp in groups], tf32_products=products)
    return {
        "name": ("fused_apply bf16-Q (eigenbasis precondition + KL partial, bfloat16 eigenvectors)"
                 if bf16 else "fused_apply (eigenbasis precondition + KL partial)"),
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/fused_apply.cu",
        "replaces": "kfac_pytorch_tpu/ops/apply_kernels.py:190",
        "unit": f"{len(groups)} shape groups ({len(shapes)} layers) of one step"
                + (", QA and QG bfloat16" if bf16 else "")
                + (f", owner rank {owner_rank} of 2" if owner_rank is not None else ""),
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "tolerance": f"|kernel - plain| <= {tol} * max|plain| per group (v and vg)",
        "repeat_bitwise_equal": True,
        "ms": time_ms(lambda: [ak.fused_precondition_stack(*grp, lam) for grp in groups]),
        **device_spans(lambda: [ak.fused_precondition_stack(*grp, lam) for grp in groups],
                       "chain_mma"),
        "plain_ms": time_ms(lambda: [ak.fused_precondition_stack_plain(*grp, lam) for grp in groups]),
        "library_ms": time_ms(lambda: [library_one(*lib) for lib in lib_groups]),
        "library": "batched torch.matmul chain per group" + (" (float32 Q)" if bf16 else ""),
        "bound_ms": tc[0],
        "bound_by": tc[1],
        "bound_route": (f"{products} TF32 products per product on the tensor cores: {products} x "
                        f"FLOPs / 495 TFLOP/s; Q read as {q_bytes} bytes an entry"),
        "bound_f32_cuda_core_ms": bound_ms([work(grp[0]) for grp in groups])[0],
        "costliest_groups": sorted(per_group, key=lambda r: -r["ms"])[:5],
    }


def sgd_phase(model, device, lr, mu, wd, flush):
    """Kernel 4 over every parameter leaf of ``model`` (a module, or a list
    of the leaf tensors a train step updates), through an
    ``SGDPlan`` of the leaf set as the train step keeps one: bitwise equal
    to its plain version; one device launch per call (profiler); device
    time per call from the profiler's kernel spans with the L2 cache
    flushed before each call and back to back; the wrapper's wall time per
    call (CUDA events around back-to-back calls: host and device together),
    with the plan and with a plan built for every call. The kernel reads
    lr from device memory (a 0-d float32 tensor, as the train step hands it
    over); two launches on the same inputs agree bit for bit, and a float
    lr (filled into a tensor per call) is timed beside."""
    import torch

    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak

    gen = torch.Generator(device=device).manual_seed(1)
    leaves = model.parameters() if isinstance(model, torch.nn.Module) else model
    params = [p.detach().clone() for p in leaves]
    grads = [torch.randn(p.shape, device=device, generator=gen) for p in params]
    trace = [torch.randn(p.shape, device=device, generator=gen) for p in params]
    kp, km = [p.clone() for p in params], [m.clone() for m in trace]
    rp, rm = [p.clone() for p in params], [m.clone() for m in trace]
    pp, pm = [p.clone() for p in params], [m.clone() for m in trace]
    lr_t = torch.full((), lr, dtype=torch.float32, device=device)
    plan = ak.SGDPlan(kp, km)
    plan.launch(grads, lr_t, mu, wd)
    ak.SGDPlan(rp, rm).launch(grads, lr_t, mu, wd)
    ak.fused_sgd_apply_plain(pp, grads, pm, lr, mu, wd)
    worst_abs = max(float((got - want).abs().max()) for got, want in zip(kp + km, pp + pm))
    if not all(torch.equal(got, want) for got, want in zip(kp + km, pp + pm)):
        raise AssertionError(f"fused SGD kernel is not bitwise equal to its plain version: "
                             f"max |diff| {worst_abs:.3e}")
    if not all(torch.equal(a, b) for a, b in zip(kp + km, rp + rm)):
        raise AssertionError("fused SGD kernel: two launches on the same inputs differ")

    def call():
        plan.launch(grads, lr_t, mu, wd)

    device_ms, launches, other = kernel_spans(call, "fused_sgd", flush=flush)
    warm_ms, _, _ = kernel_spans(call, "fused_sgd")
    if launches != plan.launches_per_call or launches != 1 or other:
        raise AssertionError(f"fused SGD: {launches} kernel launches and {other} other device "
                             f"events per call over {len(params)} leaves; want 1 and 0")
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    fused_params = [torch.nn.Parameter(p.clone()) for p in params]
    opt = torch.optim.SGD(lib_params, lr=lr, momentum=mu, weight_decay=wd, foreach=True)
    fused_opt = torch.optim.SGD(fused_params, lr=lr, momentum=mu, weight_decay=wd, fused=True)
    for o, ps in ((opt, lib_params), (fused_opt, fused_params)):
        for p, g, m in zip(ps, grads, trace):
            p.grad = g
            o.state[p]["momentum_buffer"] = m.clone()
    n = sum(p.numel() for p in params)
    b_ms, b_by = bound_ms([(20 * n, 4 * n)])
    wrapper_ms = time_ms(call)
    return {
        "name": "fused_sgd (momentum + weight decay, in place)",
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/fused_sgd.cu",
        "replaces": "kfac_pytorch_tpu/ops/apply_kernels.py:325",
        "unit": f"one SGD step over {len(params)} leaves ({n} params, {20 * n / 1e6:.1f} MB moved)",
        "max_abs_err": worst_abs,
        "max_rel_err": 0.0,
        "tolerance": "bitwise",
        "ms": wrapper_ms,
        "wrapper_ms": wrapper_ms,
        "wrapper_ms_is": "wall time per call of back-to-back calls with the plan (CUDA events): "
                         "host and device together",
        "lr": "device: a float32 scalar in device memory, read once per block",
        "repeats_bitwise": True,
        "wrapper_float_lr_ms": time_ms(lambda: plan.launch(grads, lr, mu, wd)),
        "wrapper_no_plan_ms": time_ms(lambda: ak.fused_sgd_apply(kp, grads, km, lr, mu, wd)),
        "device_ms": device_ms,
        "device_ms_is": "profiler kernel span per call, L2 flushed before each call",
        "device_l2_warm_ms": warm_ms,
        "device_launches_per_call": launches,
        "vector_leaves": sum(ak.sgd_vector_leaves([p.data_ptr() for p in kp], [g.data_ptr() for g in grads],
                                                  [m.data_ptr() for m in km])),
        "plain_ms": time_ms(lambda: ak.fused_sgd_apply_plain(pp, grads, pm, lr, mu, wd)),
        "library_ms": time_ms(opt.step),
        "library": "torch.optim.SGD(foreach=True).step",
        "library_fused_ms": time_ms(fused_opt.step),
        "library_fused": "torch.optim.SGD(fused=True).step",
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def token_count_phase(ids, vocab):
    """Kernel 2 on one LM batch's token ids: bitwise equal to its plain
    version and to the scatter-add oracle; one device launch per call and
    no other device event (no memset, no second kernel); an id outside the
    vocabulary binned nowhere and raised by the deferred
    ``check_token_ids``; device time per call from the profiler's kernel
    spans, wrapper wall time per call from CUDA events."""
    import torch

    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
    from kfac_pytorch_tpu_torch.ops import factors

    fk.check_token_ids(ids.device)
    got = fk.compute_a_embed_fused(ids, vocab)
    want = fk.compute_a_embed_fused_plain(ids, vocab)
    if not (torch.equal(got, want) and torch.equal(got, factors.compute_a_embed(ids, vocab))):
        raise AssertionError(
            f"token-count kernel is not bitwise equal to its plain version: "
            f"max |diff| {float((got - want).abs().max()):.3e}"
        )
    fk.check_token_ids(ids.device)  # every id in range: nothing to raise
    bad = ids.clone()
    bad.view(-1)[:2] = torch.tensor([-1, vocab])
    fk.compute_a_embed_fused(bad, vocab)
    try:
        fk.check_token_ids(ids.device)
    except ValueError as e:
        if f"ids must lie in [0, {vocab})" not in str(e):
            raise
    else:
        raise AssertionError("check_token_ids did not raise for ids outside the vocabulary")

    def call():
        fk.compute_a_embed_fused(ids, vocab)

    device_ms, launches, other = kernel_spans(call, "token_count")
    if launches != 1 or other:
        raise AssertionError(f"token count: {launches} kernel launches and {other} other device "
                             "events per call; want 1 and 0")
    flat = ids.reshape(-1)
    n = flat.numel()
    b_ms, b_by = bound_ms([(ids.element_size() * n + 4 * vocab, n)])
    wrapper_ms = time_ms(call)
    return {
        "name": "token_count (embedding diagonal A)",
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/token_count.cu",
        "replaces": "kfac_pytorch_tpu/ops/factor_kernels.py:471",
        "unit": f"one capture step: {n} {str(ids.dtype).split('.')[-1]} ids, vocab {vocab} (no host "
                "sync: the id-range check is deferred to check_token_ids)",
        "max_abs_err": float((got - want).abs().max()),
        "tolerance": "bitwise",
        "deferred_range_check": "ids -1 and V binned nowhere, raised by check_token_ids",
        "ms": wrapper_ms,
        "wrapper_ms": wrapper_ms,
        "wrapper_ms_is": "wall time per call of back-to-back calls (CUDA events): host and device together",
        "device_ms": device_ms,
        "device_ms_is": "profiler kernel span per call",
        "device_launches_per_call": launches,
        "plain_ms": time_ms(lambda: fk.compute_a_embed_fused_plain(ids, vocab)),
        "library_ms": time_ms(lambda: torch.bincount(flat, minlength=vocab).float() / n),
        "library": "torch.bincount(ids, minlength=V).float() / N",
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_note": "below any launch: one launch is the practical floor",
    }


# Phase 30: the compiled step. The CIFAR twin's recipe on a written set of
# 5 x 640 training images (25 steps of 128 an epoch, cut to 20) and 500
# test images; the eager run's numbers are the graphed run's reference.
COMPILED_PER_BATCH = 640
COMPILED_TEST = 500
COMPILED_STEPS = 20
COMPILED_EPOCHS = 2
COMPILED_FLAGS = ["--kfac-diagnostics", "--damping-schedule", "1"]
# Graphed against eager, relative, where not bitwise: a graph replays the
# kernels the eager step launches, on the same inputs.
COMPILED_RTOL = 1e-6


def graphed(setup):
    """A path's ``setup`` (``resnet_setup``, ``lm_setup``,
    ``imagenet_setup``) with its step wrapped in ``GraphedTrainStep``."""
    def graphed_setup(device, extra=()):
        from kfac_pytorch_tpu_torch.training.graphs import GraphedTrainStep

        step_fn, state, kfac, batches, args = setup(device, extra)
        return GraphedTrainStep(step_fn, device), state, kfac, batches, args

    return graphed_setup


def _largest_diff(got, want, where=""):
    """``(relative difference, absolute difference, where)`` of the most
    differing tensor of two trees of one structure (0 where bitwise)."""
    import torch

    if isinstance(want, torch.Tensor):
        if torch.equal(got, want):
            return 0.0, 0.0, where
        d = float((got.double() - want.double()).abs().max())
        return d / max(float(want.double().abs().max()), 1e-30), d, where
    if isinstance(want, dict):
        return max((_largest_diff(got[k], want[k], f"{where}/{k}") for k in want),
                   default=(0.0, 0.0, where))
    return (0.0, 0.0, where) if got == want else (float("inf"), float("inf"), where)


def compiled_step_phase(device, counters):
    """Phase 30 (see the docstring): the CIFAR twin graphed against eager."""
    import os

    import torch

    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt

    out, runs, eager_reason = {}, {}, trainer.eager_step_reason
    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_graphs_") as tmp:
            data_dir = write_cifar_set(os.path.join(tmp, "data"), COMPILED_PER_BATCH,
                                       COMPILED_TEST)
            for mode in ("graphed", "eager"):
                ck, tel = os.path.join(tmp, f"ck_{mode}"), os.path.join(tmp, f"tel_{mode}")
                argv = cifar_args(data_dir, [
                    "--epochs", str(COMPILED_EPOCHS), "--steps-per-epoch", str(COMPILED_STEPS),
                    "--checkpoint-dir", ck, "--telemetry-dir", tel], COMPILED_FLAGS)
                if mode == "eager":
                    trainer.eager_step_reason = lambda *_: "phase 30's eager reference"
                try:
                    hist, launches = counted(lambda: trainer.main(argv), counters)
                finally:
                    trainer.eager_step_reason = eager_reason
                saved = torch.load(ckpt.checkpoint_path(ck, COMPILED_EPOCHS - 1),
                                   map_location=device, weights_only=True)
                runs[mode] = (hist, launches, saved)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    (g, g_launches, g_saved), (e, e_launches, e_saved) = runs["graphed"], runs["eager"]
    steps = COMPILED_EPOCHS * COMPILED_STEPS
    if len(g["loss"]) != steps or len(e["loss"]) != steps or "compiled_step" in e:
        raise AssertionError(f"graphed {len(g['loss'])} and eager {len(e['loss'])} steps of "
                             f"{steps}, the eager run graphed: {'compiled_step' in e}")
    kinds = sorted(set(g["kind"]))
    rec = g["compiled_step"]
    eager_keys = len(rec["eager_calls"])
    retraces = g["telemetry"]["counters"].get("compile/retraces", 0.0)
    cache_gauge = g["telemetry"]["gauges"].get("compile/cache_size/train_step")
    bitwise_losses = sum(a == b for a, b in zip(g["loss"], e["loss"]))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(g["loss"], e["loss"]))
    diffs = {key: _largest_diff(g_saved[key], e_saved[key], key)
             for key in ("model", "opt_state", "kfac_state")}
    n_tensors = sum(_tree_equal(e_saved[key], e_saved[key], key) for key in diffs)  # a count
    worst = max(diffs.values())
    out.update({
        "run": (f"{MODEL} batch {BATCH}, {COMPILED_EPOCHS} epochs x {COMPILED_STEPS} steps on "
                f"a written CIFAR-format set, lr warmup, --damping-schedule 1, "
                "--kfac-diagnostics, deterministic cuDNN"),
        "step_kinds": kinds,
        "losses_bitwise": bitwise_losses, "steps": steps, "losses_max_rel_diff": loss_rel,
        "final_tensors": n_tensors,
        "final_tensors_max_rel_diff": worst[0], "final_tensors_max_abs_diff": worst[1],
        "final_tensors_max_diff_at": worst[2],
        "graphs": rec["graphs"], "budget": rec["budget"],
        "variants_eager_by_rule": rec["eager_calls"],
        "compile_retraces": retraces, "compile_cache_size_gauge": cache_gauge,
        "replays": rec["replays"],
        "capture_ms": rec["capture_ms"],
        "launches": {"graphed": g_launches, "eager": e_launches},
        "step_ms_median_by_kind": {"graphed": kind_medians(g), "eager": kind_medians(e)},
        "val_loss": {"graphed": g["val_loss"], "eager": e["val_loss"]},
    })
    if bitwise_losses != steps or worst[0] > 0.0:
        print(f"compiled step: {bitwise_losses} of {steps} losses bitwise, the largest "
              f"difference {loss_rel:.3e} relative; final tensors: the largest difference "
              f"{worst[0]:.3e} relative ({worst[1]:.3e} absolute) at {worst[2]}", flush=True)
    if not (loss_rel <= COMPILED_RTOL and worst[0] <= COMPILED_RTOL):
        raise AssertionError(f"the graphed recipe differs from the eager one: losses "
                             f"{loss_rel:.3e}, tensors {worst[0]:.3e} at {worst[2]}")
    if rec["graphs"] != rec["budget"] - eager_keys:
        raise AssertionError(f"{rec['graphs']} graphs captured, the budget "
                             f"{rec['budget']} less {eager_keys} eager variants implies "
                             f"{rec['budget'] - eager_keys}")
    if retraces or cache_gauge != rec["graphs"]:
        raise AssertionError(f"compile/retraces {retraces}, cache size gauge {cache_gauge}")
    if g_launches != e_launches or not g_launches["fused_sgd_apply"]:
        raise AssertionError(f"launches graphed {g_launches} against eager {e_launches}")
    if not rec["replays"]:
        raise AssertionError("the graphed run replayed no graph")
    mark("30b. ResNet-32 capture window, graphed and eager")
    window = [(("--steps-per-epoch", "10"), [("capture", 2, 10)])]
    prof = {"graphed": profile_path(graphed(resnet_setup), device, window)["capture"],
            "eager": profile_path(resnet_setup, device, window)["capture"]}
    out["capture_window"] = {
        mode: {k: p[k] for k in ("steps", "wall_ms_per_step", "device_busy_ms_per_step",
                                 "device_idle_share", "device_events")}
        for mode, p in prof.items()}
    return out


# Phase 31: the compiled step on the LM and ImageNet twins, graphed against
# eager on the same data. The LM recipe (phase 8's widths) over 2 epochs of
# 10 steps (refreshes at 0 and 10) with --kfac-diagnostics, then --remat,
# --qkv-lens, --moe-experts 4 and --solver streaming (its boundaries every
# 3 steps, so the one at step 3 decides by the drift) over 6 steps each;
# ResNeXt-50 at batch 32, 224x224 over 2 epochs of 6 steps with
# --diag-warmup 1 (refreshes at 0 and 10, the warmup's flip at 6), then
# --bf16, --batches-per-allreduce 2 and --kfac-update-freq 0 over 6 steps
# each. Every run writes a checkpoint at each epoch's end; the LM's runs
# keep telemetry for the recompile monitor's counters.
TWIN_GRAPH_STEPS = 6
LM_GRAPH_RUNS = (  # (name, flags, epochs, steps per epoch)
    ("recipe", ["--kfac-diagnostics"], 2, 10),
    ("remat", ["--remat"], 1, TWIN_GRAPH_STEPS),
    ("qkv_lens", ["--qkv-lens"], 1, TWIN_GRAPH_STEPS),
    ("moe4", ["--moe-experts", "4"], 1, TWIN_GRAPH_STEPS),
    ("streaming", ["--solver", "streaming", "--kfac-update-freq", "3"], 1, TWIN_GRAPH_STEPS),
)
IMAGENET_GRAPH_RUNS = (
    ("recipe_diag_warmup", ["--diag-warmup", "1"], 2, 6),
    ("bf16", ["--bf16"], 1, TWIN_GRAPH_STEPS),
    ("accum2", ["--batches-per-allreduce", "2"], 1, TWIN_GRAPH_STEPS),
    ("sgd", ["--kfac-update-freq", "0"], 1, TWIN_GRAPH_STEPS),
)
# the kernels each twin's K-FAC step launches, by counter
LM_GRAPH_KERNELS = ("compute_a_embed_fused", "fused_precondition_stack", "fused_sgd_apply",
                    "flash_forward", "flash_backward_dq", "flash_backward_dkv")
IMAGENET_GRAPH_KERNELS = ("compute_a_conv_fused", "compute_a_conv_grouped_fused",
                          "fused_precondition_stack", "fused_sgd_apply")


def graphed_pair(trainer, argv, epochs, counters, tmp, name):
    """``trainer.main(argv)`` graphed and eager (the twin's
    ``eager_step_reason`` patched), each with the counters zeroed just
    before and its checkpoints under ``tmp``: ``{mode: (history, launches,
    last checkpoint)}``."""
    import os
    import shutil

    import torch

    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt

    runs, reason = {}, trainer.eager_step_reason
    for mode in ("graphed", "eager"):
        ck = os.path.join(tmp, f"{name}_{mode}")
        if mode == "eager":
            trainer.eager_step_reason = lambda *_: "phase 31's eager reference"
        try:
            hist, launches = counted(lambda: trainer.main([*argv, "--checkpoint-dir", ck]),
                                     counters)
        finally:
            trainer.eager_step_reason = reason
        saved = torch.load(ckpt.checkpoint_path(ck, epochs - 1), map_location="cpu",
                           weights_only=True)
        shutil.rmtree(ck)
        runs[mode] = (hist, launches, saved)
        torch.cuda.empty_cache()
    return runs


def gate_graphed_pair(path, runs, steps, kernels, telemetry):
    """Phase 31's checks of one pair (see the module docstring), and its
    record."""
    from kfac_pytorch_tpu_torch.training.graphs import eager_variant_reason

    (g, g_launches, g_saved), (e, e_launches, e_saved) = runs["graphed"], runs["eager"]
    if len(g["loss"]) != steps or len(e["loss"]) != steps or "compiled_step" in e:
        raise AssertionError(f"{path}: graphed {len(g['loss'])} and eager {len(e['loss'])} "
                             f"steps of {steps}, the eager run graphed: {'compiled_step' in e}")
    rec = g["compiled_step"]
    bitwise = sum(a == b for a, b in zip(g["loss"], e["loss"]))
    diffs = [_largest_diff(g_saved[k], e_saved[k], k) for k in ("model", "opt_state", "kfac_state")]
    n_tensors = sum(_tree_equal(e_saved[k], e_saved[k], k)
                    for k in ("model", "opt_state", "kfac_state"))
    worst = max(diffs)
    if bitwise != steps or worst[0] > 0.0:
        raise AssertionError(f"{path}: {bitwise} of {steps} losses bitwise; final tensors: the "
                             f"largest difference {worst[0]:.3e} relative at {worst[2]}")
    if g_launches != e_launches:
        raise AssertionError(f"{path}: launches graphed {g_launches} against eager {e_launches}")
    in_replays = {}
    for c in rec["capture_ms"]:
        for k, n in c["launches_per_replay"].items():
            in_replays[k] = in_replays.get(k, 0) + n
    missing = [k for k in kernels if not g_launches.get(k) or not in_replays.get(k)]
    if missing:
        raise AssertionError(f"{path}: {missing} not launched inside a replay "
                             f"(per replay {in_replays}, run {g_launches})")
    eager_keys = [c["flags"] for c in rec["eager_calls"]]
    if not all(eager_variant_reason(f) for f in eager_keys):
        raise AssertionError(f"{path}: variants run eagerly outside the rule: {eager_keys}")
    if rec["graphs"] + len(eager_keys) > rec["budget"] or not rec["replays"]:
        raise AssertionError(f"{path}: {rec['graphs']} graphs and {len(eager_keys)} eager "
                             f"variants for a budget of {rec['budget']}, "
                             f"{rec['replays']} replays")
    out = {
        "steps": steps, "losses_bitwise": bitwise, "final_tensors_bitwise": n_tensors,
        "step_kinds": sorted(set(g["kind"])),
        "graphs": rec["graphs"], "budget": rec["budget"], "replays": rec["replays"],
        "variants_eager_by_rule": rec["eager_calls"], "capture_ms": rec["capture_ms"],
        "launches": {"graphed": g_launches, "eager": e_launches},
        "step_ms_median_by_kind": {"graphed": kind_medians(g), "eager": kind_medians(e)},
        "step0_ms": {"graphed": g["step_ms"][0], "eager": e["step_ms"][0]},
    }
    if telemetry:
        retraces = g["telemetry"]["counters"].get("compile/retraces", 0.0)
        gauge = g["telemetry"]["gauges"].get("compile/cache_size/train_step")
        if retraces or gauge != rec["graphs"]:
            raise AssertionError(f"{path}: compile/retraces {retraces}, cache size gauge {gauge}")
        out.update({"compile_retraces": retraces, "compile_cache_size_gauge": gauge})
    return out


def twin_compiled_step_phase(device, counters):
    """Phase 31 (see the module docstring): the LM and ImageNet twins
    graphed against eager."""
    import os

    import torch

    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as imagenet_trainer
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm_trainer

    out = {"lm": {}, "imagenet": {}}
    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_twin_graphs_") as tmp:
            for name, flags, epochs, per_epoch in LM_GRAPH_RUNS:
                argv = [*LM_ARGS, *flags, "--epochs", str(epochs), "--steps-per-epoch",
                        str(per_epoch), "--telemetry-dir", os.path.join(tmp, f"tel_{name}")]
                runs = graphed_pair(lm_trainer, argv, epochs, counters, tmp, f"lm_{name}")
                # streaming truncates every LM side (all 512 wide or more):
                # its apply takes the Woodbury solves, not kernel 3
                kernels = tuple(k for k in LM_GRAPH_KERNELS
                                if name != "streaming" or k != "fused_precondition_stack")
                out["lm"][name] = gate_graphed_pair(f"31a LM {name}", runs, epochs * per_epoch,
                                                    kernels, telemetry=True)
            mark("31b. the compiled step: the ImageNet twin")
            for name, flags, epochs, per_epoch in IMAGENET_GRAPH_RUNS:
                argv = [*IMAGENET_ARGS, *flags, "--epochs", str(epochs), "--steps-per-epoch",
                        str(per_epoch)]
                runs = graphed_pair(imagenet_trainer, argv, epochs, counters, tmp,
                                    f"imagenet_{name}")
                kernels = () if name == "sgd" else tuple(
                    f"{k}:bf16" if name == "bf16" and "conv" in k else k
                    for k in IMAGENET_GRAPH_KERNELS)
                out["imagenet"][name] = gate_graphed_pair(
                    f"31b ResNeXt {name}", runs, epochs * per_epoch, kernels, telemetry=False)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    mark("31c. LM and ResNeXt capture windows, graphed and eager")
    window = [(("--steps-per-epoch", "10"), [("capture", 2, 10)])]
    for path, setup in (("lm", lm_setup), ("imagenet", imagenet_setup)):
        prof = {"graphed": profile_path(graphed(setup), device, window)["capture"],
                "eager": profile_path(setup, device, window)["capture"]}
        out[path]["capture_window"] = {
            mode: {k: p[k] for k in ("steps", "wall_ms_per_step", "device_busy_ms_per_step",
                                     "device_idle_share", "device_events")}
            for mode, p in prof.items()}
    return out


def graph_phase(model, ids, vocab, device, lr, mu, wd):
    """Kernels 4 and 2 under CUDA-graph capture: one ``fused_sgd_apply``
    call over ``model``'s leaf set (through its plan) and one
    ``compute_a_embed_fused`` call on the LM batch, each captured in a
    ``torch.cuda.CUDAGraph`` (a host sync in either wrapper fails the
    capture), then replayed on new inputs copied into the captured buffers.
    The replays must equal eager calls on the same inputs bit for bit."""
    import torch

    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk

    gen = torch.Generator(device=device).manual_seed(5)

    def randn_like_all(ts):
        return [torch.randn(t.shape, device=device, generator=gen) for t in ts]

    params = [p.detach().to(device, copy=True) for p in model.parameters()]
    grads, trace = randn_like_all(params), randn_like_all(params)
    plan = ak.SGDPlan(params, trace)
    static_ids = ids.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream, as torch.cuda.graphs asks
        plan.launch(grads, lr, mu, wd)
        fk.compute_a_embed_fused(static_ids, vocab)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    sgd_graph, tok_graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(sgd_graph):
        plan.launch(grads, lr, mu, wd)
    with torch.cuda.graph(tok_graph):
        out = fk.compute_a_embed_fused(static_ids, vocab)

    new_p, new_m, new_g = (randn_like_all(params) for _ in range(3))
    for dst, src in zip(params + trace + grads, new_p + new_m + new_g):
        dst.copy_(src)
    sgd_graph.replay()
    eager_p, eager_m = [p.clone() for p in new_p], [m.clone() for m in new_m]
    ak.fused_sgd_apply(eager_p, new_g, eager_m, lr, mu, wd)
    if not all(torch.equal(a, b) for a, b in zip(params + trace, eager_p + eager_m)):
        raise AssertionError("fused SGD: the CUDA-graph replay differs from an eager call")
    new_ids = torch.randint(0, vocab, ids.shape, device=device, generator=gen, dtype=ids.dtype)
    static_ids.copy_(new_ids)
    tok_graph.replay()
    want = fk.compute_a_embed_fused(new_ids, vocab)
    if not (torch.equal(out, want) and torch.equal(out, fk.compute_a_embed_fused_plain(new_ids, vocab))):
        raise AssertionError("token count: the CUDA-graph replay differs from an eager call")
    fk.check_token_ids(device)
    return {
        "fused_sgd": f"captured and replayed over {len(params)} leaves on new inputs: bitwise equal to eager",
        "token_count": f"captured and replayed on {new_ids.numel()} new ids: bitwise equal to eager and plain",
    }


def flash_qkv(device, b, t, h, d, seed):
    """q, k, v as strided views of one fused projection, as the model hands
    them over, and a cotangent ``do``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, device=device, generator=gen)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    return q, k, v, torch.randn(b, t, h, d, device=device, generator=gen)


def flash_backward_errs(q, k, v, do, lse, delta, causal):
    """Kernels 6 and 7 against ``flash_backward_plain``: ``{"dq": (abs,
    rel), "dkv": (abs, rel)}``, and the kernels' outputs."""
    from kfac_pytorch_tpu_torch.ops import flash_attention as fa

    dq = fa.flash_backward_dq(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse, delta, causal)
    dq_p, dk_p, dv_p = fa.flash_backward_plain(q, k, v, do, lse, delta, causal)
    errs = {}
    for part, pairs in (("dq", [(dq, dq_p)]), ("dkv", [(dk, dk_p), (dv, dv_p)])):
        worst = [scaled_err(g, w) for g, w in pairs]
        errs[part] = (max(e for e, _ in worst), max(r for _, r in worst))
    return errs, (dq, dk, dv)


# small checks of all three kernels beside the LM shape: a ragged T (no
# multiple of the 64-row tile), no causal mask, and the other head widths
# (D = 128 streams 32-row tiles)
FLASH_EDGE_CASES = [(1, 200, 2, 64, True), (2, 256, 2, 64, False),
                    (1, 200, 2, 32, False), (1, 200, 2, 128, True), (2, 136, 1, 128, False)]


def flash_forward_errs(q, k, v, causal):
    """Kernel 5 against ``flash_forward_plain`` (out and lse) and against
    SDPA in float32 (out): ``((abs, rel), sdpa rel)``, and its outputs."""
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_forward(q, k, v, causal)
    out_p, lse_p = fa.flash_forward_plain(q, k, v, causal)
    worst = [scaled_err(g, w) for g, w in ((out, out_p), (lse, lse_p))]
    sdpa = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)), is_causal=causal)
    return ((max(e for e, _ in worst), max(r for _, r in worst)),
            scaled_err(out, sdpa.transpose(1, 2))[1]), (out, lse)


def flash_phase(device, b, t, h, d):
    """Kernels 5, 6 and 7 at one LM layer's attention shapes and at
    ``FLASH_EDGE_CASES`` (the forward also against SDPA); two launches of
    each kernel must agree bit for bit."""
    import torch
    import torch.nn.functional as F

    from kfac_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash_qkv(device, b, t, h, d, seed=2)
    (fwd_err, sdpa_rel), (out, lse) = flash_forward_errs(q, k, v, True)
    out_p, lse_p = fa.flash_forward_plain(q, k, v, True)
    delta = (do * out_p).sum(dim=-1).transpose(1, 2).contiguous()
    errs, grads = flash_backward_errs(q, k, v, do, lse_p, delta, True)
    errs["forward"] = fwd_err
    tols = {"forward": 2e-5, "dq": 1e-4, "dkv": 1e-4}
    edge = {"forward": 0.0, "forward_sdpa": 0.0, "dq": 0.0, "dkv": 0.0}
    for case in FLASH_EDGE_CASES:
        eq, ek, ev, edo = flash_qkv(device, *case[:4], seed=3)
        (case_fwd, case_sdpa), _ = flash_forward_errs(eq, ek, ev, case[4])
        e_out, e_lse = fa.flash_forward_plain(eq, ek, ev, case[4])
        e_delta = (edo * e_out).sum(dim=-1).transpose(1, 2).contiguous()
        case_errs, _ = flash_backward_errs(eq, ek, ev, edo, e_lse, e_delta, case[4])
        case_errs["forward"], case_errs["forward_sdpa"] = case_fwd, (None, case_sdpa)
        for part in edge:
            edge[part] = max(edge[part], case_errs[part][1])
            tol = tols[part.split("_")[0]]
            if not case_errs[part][1] <= tol:
                raise AssertionError(f"flash {part} kernel disagrees with its "
                                     f"{'SDPA' if part == 'forward_sdpa' else 'plain version'} at "
                                     f"[B, T, H, D, causal] = {list(case)}: rel "
                                     f"{case_errs[part][1]:.3e} > {tol}")
    for part, tol in tols.items():
        if not errs[part][1] <= tol:
            raise AssertionError(
                f"flash {part} kernel disagrees with its plain version: rel "
                f"{errs[part][1]:.3e} > {tol}"
            )
    if not sdpa_rel <= 2e-5:
        raise AssertionError(f"flash forward disagrees with SDPA: rel {sdpa_rel:.3e}")
    if not all(torch.equal(x, y) for x, y in zip((out, lse), fa.flash_forward(q, k, v, True))):
        raise AssertionError("flash forward kernel: two launches on the same inputs differ")
    again = (fa.flash_backward_dq(q, k, v, do, lse_p, delta, True),
             *fa.flash_backward_dkv(q, k, v, do, lse_p, delta, True))
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        raise AssertionError("flash backward kernels: two launches on the same inputs differ")

    # the library yardstick (the forward also held to it above): SDPA in
    # float32 on [B, H, T, D]
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True))
    plain_bwd_ms = time_ms(lambda: fa.flash_backward_plain(q, k, v, do, lse_p, delta, True))

    n, r = b * t * h * d, b * h * t
    tt = b * h * t * t * d  # causal: 2·tt FLOPs forward, 3·tt dQ, 4·tt dK/dV
    unit = f"one layer: [{b}, {t}, {h}, {d}] causal"
    base = {
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/flash_attention.cu",
        "unit": unit,
    }
    fwd_work = (4 * (4 * n + r), 2 * tt)
    dq_work, dkv_work = (4 * (5 * n + 2 * r), 3 * tt), (4 * (6 * n + 2 * r), 4 * tt)
    edge_cases = "[B, T, H, D, causal] in " + str([list(c) for c in FLASH_EDGE_CASES])

    def bounds(work):
        tc = bound_ms([work], tf32_products=3)
        return {"bound_ms": tc[0], "bound_by": tc[1],
                "bound_route": "3xTF32 on the tensor cores: 3 x FLOPs / 495 TFLOP/s (the share is stated "
                               "against this bound)",
                "bound_f32_cuda_core_ms": bound_ms([work])[0]}

    def backward_row(part, name, replaces, fn, work, fragment):
        return {**base, "name": name, "replaces": replaces,
                "max_abs_err": errs[part][0], "max_rel_err": errs[part][1],
                "tolerance": f"|kernel - plain| <= 1e-4 * max|plain|{' (dk and dv)' * (part == 'dkv')}",
                "edge_cases": edge_cases,
                "edge_max_rel_err": edge[part],
                "repeat_bitwise_equal": True,
                "ms": time_ms(fn),
                **device_spans(fn, fragment),
                "plain_ms": plain_bwd_ms,
                "plain": "flash_backward_plain (dq, dk and dv together)",
                "library_ms": lib_bwd_ms,
                "library": "autograd backward of SDPA (dq, dk and dv together)",
                **bounds(work)}

    return [
        {**base, "name": "flash_attention forward",
         "replaces": "kfac_pytorch_tpu/ops/flash_attention.py:125",
         "max_abs_err": errs["forward"][0], "max_rel_err": errs["forward"][1],
         "tolerance": "|kernel - plain| <= 2e-5 * max|plain| (out and lse); "
                      "|kernel - SDPA| <= 2e-5 * max|SDPA| (out)",
         "sdpa_max_rel_err": sdpa_rel,
         "edge_cases": edge_cases,
         "edge_max_rel_err": edge["forward"],
         "edge_sdpa_max_rel_err": edge["forward_sdpa"],
         "repeat_bitwise_equal": True,
         "ms": time_ms(lambda: fa.flash_forward(q, k, v, True)),
         **device_spans(lambda: fa.flash_forward(q, k, v, True), "flash_fwd"),
         "plain_ms": time_ms(lambda: fa.flash_forward_plain(q, k, v, True)),
         "library_ms": lib_fwd_ms,
         "library": "F.scaled_dot_product_attention(is_causal=True), float32",
         **bounds(fwd_work)},
        backward_row("dq", "flash_attention backward dQ", "kfac_pytorch_tpu/ops/flash_attention.py:281",
                     lambda: fa.flash_backward_dq(q, k, v, do, lse_p, delta, True), dq_work,
                     "flash_dq"),
        backward_row("dkv", "flash_attention backward dK/dV", "kfac_pytorch_tpu/ops/flash_attention.py:298",
                     lambda: fa.flash_backward_dkv(q, k, v, do, lse_p, delta, True), dkv_work,
                     "flash_dkv"),
    ]


def train_lm(extra):
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    return trainer.main([*LM_ARGS, *extra])


def lm_setup(device, extra=(), oracle=False):
    """The LM path through the library API (the twin's ``build``), with the
    trainer's hyperparameters, seed and batches: ``(step_fn, state, kfac,
    batches, args)``; ``oracle=True`` takes exact attention and the dense
    factor and apply routes."""
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
    from kfac_pytorch_tpu_torch.training import data as data_lib

    args = trainer.parse_args([*LM_ARGS, *extra])
    _, kfac, state, step_fn, splits = trainer.build(args, device, oracle)
    stream = data_lib.batchify_tokens(splits["train"], args.batch_size)
    batches = [trainer.device_batch(toks, tgts, device)
               for toks, tgts in data_lib.bptt_batches(stream, args.seq_len)]
    return step_fn, state, kfac, batches, args


def lm_oracle_losses(device, steps, extra=()):
    """The LM path's first ``steps`` losses on the oracle path (with the
    twin's ``extra`` flags)."""
    from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step

    step_fn, state, kfac, batches, args = lm_setup(device, extra, oracle=True)
    losses = []
    for i, batch in zip(range(steps), batches):
        state, m = step_fn(state, batch, args.base_lr, args.damping,
                           **kfac_flags_for_step(i, kfac, 0))
        losses.append(float(m["loss"]))
    return losses




SGD_GROUP = "fused SGD (kernel 4)"
TOKEN_GROUP = "token counts (kernel 2)"
_KERNEL_GROUPS = (  # device kernel name fragment → what it is
    ("patch_cov", "conv A factors (kernels 1, 1g)"),
    ("flash_fwd", "flash forward (kernel 5)"),
    ("flash_dq", "flash dQ (kernel 6)"),
    ("flash_dkv", "flash dK/dV (kernel 7)"),
    ("chain_mma", "fused apply (kernel 3)"),
    ("fused_sgd", SGD_GROUP),
    ("token_count", TOKEN_GROUP),
    ("sytrd", "eigh (cuSOLVER)"),
    ("syr2k", "eigh (cuSOLVER)"),
    ("rotate_batch", "eigh (cuSOLVER)"),
    ("offa_stage", "eigh (cuSOLVER)"),
    ("syev", "eigh (cuSOLVER)"),
    ("stedc", "eigh (cuSOLVER)"),
    ("ormtr", "eigh (cuSOLVER)"),
    ("orgtr", "eigh (cuSOLVER)"),
    ("larf", "eigh (cuSOLVER)"),
    ("rnn", "recurrences (cuDNN RNN)"),
    ("lstm", "recurrences (cuDNN RNN)"),
    ("gru", "recurrences (cuDNN RNN)"),
    ("fprop", "convolutions (cuDNN)"),
    ("dgrad", "convolutions (cuDNN)"),
    ("wgrad", "convolutions (cuDNN)"),
    ("conv", "convolutions (cuDNN)"),
    ("cudnn", "convolutions (cuDNN)"),
    ("gemm", "library GEMM (cuBLAS)"),
    ("cutlass", "library GEMM (cuBLAS)"),
    ("batch_norm", "BatchNorm"),
    ("elementwise", "PyTorch elementwise"),
    ("reduce_kernel", "PyTorch reductions"),
)


def profile_path(setup, device, runs):
    """Device time by kernel over windows of a path's steps, from
    ``torch.profiler``. ``runs`` is ``[(extra flags, [(label, start,
    stop), ...])]``: each run builds the path anew with ``setup(device,
    extra)``, takes steps ``0..start-1`` unprofiled and profiles each window
    ``start..stop-1`` in turn. Device time by group sums kernel durations;
    the busy share is the union of the kernels' time spans over the
    window's wall time (library kernels may overlap one another)."""
    import time

    import torch

    from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step

    out = {}
    for extra, windows in runs:
        step_fn, state, kfac, batches, args = setup(device, extra)
        damping = args.damping if kfac is not None else 0.0

        def run(i, state):
            state, m = step_fn(state, batches[i], args.base_lr, damping,
                               **kfac_flags_for_step(i, kfac, 0))
            float(m["loss"])
            return state

        step = 0
        for label, start, stop in windows:
            captures = sum(kfac_flags_for_step(i, kfac, 0)["update_factors"] for i in range(start, stop))
            for i in range(step, start):
                state = run(i, state)
            torch.cuda.synchronize()

            def window():
                nonlocal state
                t0 = time.perf_counter()
                for i in range(start, stop):
                    state = run(i, state)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            events, wall_ms = guarded_profile(window)
            step = stop
            kernels, spans, launches, order = {}, [], {}, []
            for start_ns, end_ns, name in events:
                kernels[name] = kernels.get(name, 0.0) + (end_ns - start_ns) / 1e6
                launches[name] = launches.get(name, 0) + 1
                spans.append((start_ns, end_ns))
                for frag, letter in (("fused_sgd", "S"), ("token_count", "T"), ("syevj", "E"),
                                     ("stedc", "E"), ("sytrd", "E")):
                    if frag in name:
                        order.append(letter)
                        break
            busy_ns, reach = 0, float("-inf")
            for lo, hi in sorted(spans):
                if hi > reach:
                    busy_ns += hi - max(lo, reach)
                    reach = hi
            n = stop - start
            groups, other, group_launches = {}, {}, {}
            for name, ms in kernels.items():
                group = next((g for frag, g in _KERNEL_GROUPS if frag in name.lower()), "other")
                groups[group] = groups.get(group, 0.0) + ms / n
                group_launches[group] = group_launches.get(group, 0) + launches[name]
                if group == "other":
                    other[name[:90]] = ms / n
            busy = busy_ns / 1e6
            out[label] = {
                "steps": n,
                "wall_ms_per_step": wall_ms / n,
                "device_ms_per_step": sum(kernels.values()) / n,
                "device_busy_ms_per_step": busy / n,
                "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
                "device_events": sum(launches.values()),
                "capture_steps": captures,
                # kernels 4 (S) and 2 (T) and eigh (E, once per run of its
                # kernels) in device order
                "kernel_order": "".join(x for i, x in enumerate(order)
                                        if x != "E" or i == 0 or order[i - 1] != "E"),
                "by_group_ms_per_step": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                "by_group_launches": {g: group_launches[g] for g in (SGD_GROUP, TOKEN_GROUP)
                                      if g in group_launches},
                "top_kernels_ms_per_step": {
                    k[:90]: v / n for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
                },
                "top_other_ms_per_step": dict(sorted(other.items(), key=lambda kv: -kv[1])[:8]),
            }
        del state, step_fn, batches
        torch.cuda.empty_cache()
    return out


def gate_profile_launches(profile, path):
    """From a path's profile windows: kernel 4 launches once per K-FAC step
    (the plain-SGD windows take the per-leaf step) and, on the LM, kernel 2
    once per capture step."""
    for label, w in profile.items():
        got = w["by_group_launches"]
        want = {SGD_GROUP: 0 if label == "sgd" else w["steps"]}
        if path == "lm":
            want[TOKEN_GROUP] = w["capture_steps"]
        for group, n in want.items():
            if got.get(group, 0) != n:
                raise AssertionError(f"{path} profile, {label} window: {got.get(group, 0)} {group} "
                                     f"launches over {w['steps']} steps, want {n}")


def profile_lm(device):
    """LM steps 2..11 with K-FAC (one eigen refresh), 12..16 (capture steps
    only), then 2..11 with plain SGD."""
    return profile_path(lm_setup, device, [((), [("kfac", 2, 12), ("capture", 12, 17)]),
                                           (("--kfac-update-freq", "0"), [("sgd", 2, 12)])])


def lm_expected_launches(hist, model, remat=False):
    """What the LM run implies for each counter: token counts on every capture
    step; one apply launch per shape group (a lens-split QKV projection
    counts as its ``out/3``-wide splits) and one SGD launch per step;
    flash forward per layer on every train step (twice under ``--remat``:
    the recompute) and validation batch, its two backward kernels per layer
    on every train step."""
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
    from kfac_pytorch_tpu_torch.models.layers import KFACDense
    from kfac_pytorch_tpu_torch.training import data as data_lib

    args = trainer.parse_args(LM_ARGS)
    splits, _ = data_lib.synthetic_corpus(vocab_size=trainer.SYNTHETIC_VOCAB)
    val = data_lib.batchify_tokens(splits["valid"], args.batch_size)
    val_batches = len(list(data_lib.bptt_batches(val, args.seq_len))) * len(hist["val_loss"])
    steps = len(hist["loss"])
    captures = sum(k != "plain" for k in hist["kind"])
    groups = len({(m.out_features // m.lens_splits, m.in_features + 1)
                  for m in model.modules() if isinstance(m, KFACDense)})
    layers = len(model.blocks)
    return {
        "token_count": captures,
        "fused_apply": groups * steps,
        "fused_sgd": steps,
        "flash_forward": layers * ((2 if remat else 1) * steps + val_batches),
        "flash_dq": layers * steps,
        "flash_dkv": layers * steps,
    }


def step_stats(hist, tokens_per_step):
    ms = hist["step_ms"][1:]  # step 0 pays first-call set-up (cuSOLVER, caches)
    kinds = hist["kind"][1:]
    out = {"step0_ms": hist["step_ms"][0],
           "per_s": tokens_per_step * len(ms) / (sum(ms) / 1e3),
           "mean_ms": sum(ms) / len(ms)}
    for kind in ("capture", "refresh", "plain"):
        sel = [m for m, k in zip(ms, kinds) if k == kind]
        if sel:
            out[f"{kind}_ms_median"] = statistics.median(sel)
    return out


def train(extra):
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    return trainer.main([*RESNET_ARGS, "--steps-per-epoch", str(STEPS), *extra])


def resnet_setup(device, extra=()):
    """The ResNet-32 path through the library API (the twin's ``build``),
    with the trainer's hyperparameters, seed and synthetic batches:
    ``(step_fn, state, kfac, batches, args)``."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.training.data import synthetic_batches

    args = trainer.parse_args([*RESNET_ARGS, *extra])
    _, kfac, state, step_fn = trainer.build(args, device)
    batches = [(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
               for x, y in synthetic_batches(args.batch_size, (3, 32, 32), trainer.NUM_CLASSES,
                                             args.steps_per_epoch, seed=args.seed)]
    return step_fn, state, kfac, batches, args


def train_imagenet(extra):
    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as trainer

    return trainer.main([*IMAGENET_ARGS, *extra])


def imagenet_setup(device, extra=()):
    """The ResNeXt path through the library API (the twin's ``build``), with
    the trainer's hyperparameters, seed and synthetic batches: ``(step_fn,
    state, kfac, batches, args)``."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as trainer
    from kfac_pytorch_tpu_torch.training.data import synthetic_batches

    args = trainer.parse_args([*IMAGENET_ARGS, *extra])
    _, kfac, state, step_fn = trainer.build(args, device)
    im = args.image_size
    batches = [(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
               for x, y in synthetic_batches(args.batch_size, (3, im, im), trainer.NUM_CLASSES,
                                             args.steps_per_epoch, seed=args.seed)]
    return step_fn, state, kfac, batches, args


def _clone(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def one_step_oracle(setup, device, steps, extra=(), steps_per_epoch=None):
    """A kernel path's first ``steps`` losses, and the oracle path's
    (``factor_kernel="dense"``, ``apply_kernel="dense"``) where every
    oracle step starts from the kernel path's state: before kernel step
    ``i``, the oracle path takes step ``i - 1`` from the kernel path's state
    before that step, then reports the loss of its step ``i``. Each pair
    then differs by one step's rounding, not by the compounded rounding of
    ``i`` steps, which ResNeXt amplifies beyond any useful bound (phase 12
    prints the free-running runs beside it). ``setup`` is ``resnet_setup``
    or ``imagenet_setup`` with the flags ``extra``; epochs of
    ``steps_per_epoch`` steps (all ``steps`` by default) each replay the
    setup's batches from the first, as the twins' synthetic batches do."""
    from kfac_pytorch_tpu_torch.training.step import TrainState, kfac_flags_for_step

    spe = steps_per_epoch or steps
    n = (*extra, "--steps-per-epoch", str(spe))
    k_fn, k_state, kfac, batches, args = setup(device, n)
    d_fn, d_state, _, _, _ = setup(device, (*n, "--factor-kernel", "dense",
                                            "--apply-kernel", "dense"))

    def snapshot(state):
        return (_clone(state.model.state_dict()), _clone(state.opt_state), _clone(state.kfac_state))

    def restore(state, snap):
        sd, opt, kf = snap
        state.model.load_state_dict(sd)
        for name, t in opt.items():
            state.opt_state[name].copy_(t)
        return TrainState(step=state.step, model=state.model, opt_state=state.opt_state,
                          kfac_state=_clone(kf))

    def step(fn, state, i):
        state, m = fn(state, batches[i % spe], args.base_lr, args.damping,
                      **kfac_flags_for_step(i, kfac, i // spe))
        return state, float(m["loss"])

    kernel, oracle, prev = [], [], None
    for i in range(steps):
        if prev is not None:  # step 0: both start from the same seed's weights
            d_state = restore(d_state, prev)
            d_state, _ = step(d_fn, d_state, i - 1)
        d_state, d_loss = step(d_fn, d_state, i)
        prev = snapshot(k_state)
        k_state, k_loss = step(k_fn, k_state, i)
        kernel.append(k_loss)
        oracle.append(d_loss)
    return kernel, oracle


def conv_expected_launches(hist, model, device, bf16=False):
    """What a ResNet or ResNeXt run implies for each counter: on every
    capture step kernel 1 once per ungrouped conv and kernel 1g once per
    grouped conv; one apply launch per shape group and one SGD launch per
    step. With ``bf16`` (``--bf16 --eigen-dtype bf16``) the bf16 routes'
    counts too: every conv but the stem, whose input is the float32 batch,
    takes bfloat16 activations, and every apply launch bfloat16 Q."""
    from kfac_pytorch_tpu_torch import KFAC, capture
    from kfac_pytorch_tpu_torch.models.layers import KFACConv
    from kfac_pytorch_tpu_torch.ops import precondition as pc

    captures = sum(k != "plain" for k in hist["kind"])
    convs = [m for m in model.modules() if isinstance(m, KFACConv)]
    facs = KFAC(layers=capture.discover_layers(model), device=device)._identity_factors(model)
    groups = pc.shape_groups({n: (f["G"].shape[0], f["A"].shape[0]) for n, f in facs.items()})
    steps = len(hist["loss"])
    out = {
        "compute_a_conv_fused": captures * sum(m.groups == 1 for m in convs),
        "compute_a_conv_grouped_fused": captures * sum(m.groups > 1 for m in convs),
        "fused_precondition_stack": len(groups) * steps,
        "fused_sgd_apply": steps,
    }
    if bf16:
        out["compute_a_conv_fused:bf16"] = out["compute_a_conv_fused"] - captures
        out["compute_a_conv_grouped_fused:bf16"] = out["compute_a_conv_grouped_fused"]
        out["fused_precondition_stack:bf16"] = out["fused_precondition_stack"]
    return out


def write_cifar_set(root, per_batch=CIFAR_PER_BATCH, n_test=CIFAR_TEST, seed=0):
    """Five ``data_batch_*`` files of ``per_batch`` images and a
    ``test_batch`` of ``n_test`` in ``root/cifar-10-batches-py``: the
    stand-in's images denormalized and quantized to uint8, channel-major
    rows of 3·32·32, as CIFAR-10 stores them."""
    import os
    import pickle

    import numpy as np

    from kfac_pytorch_tpu_torch.training import data as data_lib

    (x, y), (xt, yt) = data_lib.synthetic_cifar_like(
        n_train=5 * per_batch, n_test=n_test, seed=seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)

    def dump(name, images, labels):
        u = (images * data_lib.CIFAR10_STD[:, None, None]
             + data_lib.CIFAR10_MEAN[:, None, None]) * 255.0
        raw = np.clip(np.rint(u), 0, 255).astype(np.uint8).reshape(len(images), -1)
        with open(os.path.join(base, name), "wb") as fh:
            pickle.dump({b"data": raw, b"labels": [int(v) for v in labels]}, fh)

    for i in range(5):
        sl = slice(i * per_batch, (i + 1) * per_batch)
        dump(f"data_batch_{i + 1}", x[sl], y[sl])
    dump("test_batch", xt, yt)
    return root


def cifar_args(data_dir, extra=(), flags=CIFAR_FLAGS):
    """The CIFAR path with data, its batches from the native loader
    (``padcrop``) on ``LOADER_WORKERS`` threads, the JAX trainer's default;
    ``flags`` the path's diagnostics and BatchNorm recalibration."""
    return ["--data-dir", data_dir, "--model", MODEL, "--batch-size", str(BATCH),
            "--steps-per-epoch", str(CIFAR_STEPS), "--seed", "0", "--device", "cuda",
            "--num-workers", str(LOADER_WORKERS), *flags, *extra]


def zero_counts(counters):
    """Every launch counter to 0, the bf16 routes' (``launches_bf16``) too."""
    for fn in counters:
        fn.launches = 0
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0


def read_counts(counters):
    """``{name: launches}``, and ``{name:bf16: launches}`` of the kernels
    with a bf16 route."""
    out = {}
    for fn in counters:
        out[fn.__name__] = fn.launches
        if hasattr(fn, "launches_bf16"):
            out[f"{fn.__name__}:bf16"] = fn.launches_bf16
    return out


def counted(run, counters):
    """``(run(), {counter: launches})`` with every counter zeroed just before."""
    zero_counts(counters)
    out = run()
    return out, read_counts(counters)


def gate_launches(launches, expected, path):
    for name, n in launches.items():
        if n != expected.get(name, 0):
            raise AssertionError(
                f"{name}: {n} launches on the {path} path, the run implies {expected.get(name, 0)}")


def gate_falling(losses, path):
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss on the {path} path: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"{path}: loss did not fall: first-5 mean {first:.4f}, "
                             f"last-5 mean {last:.4f}")
    return first, last


def gate_oracle(kernel, oracle, path, steps, rtol=1e-3):
    """Each listed step's loss within ``rtol`` relative of the oracle
    path's; returns the largest relative difference."""
    worst = 0.0
    for i in steps:
        rel = abs(kernel[i] - oracle[i]) / abs(oracle[i])
        if not rel <= rtol:
            raise AssertionError(f"{path} step {i}: kernel-path loss {kernel[i]} vs oracle-path "
                                 f"loss {oracle[i]}")
        worst = max(worst, rel)
    return worst


def cifar_expected_launches(hist, device, a_per_capture=1, apply_kernels=True, bf16=False):
    """``conv_expected_launches`` of a ResNet-32 run, with kernel 1 launched
    ``a_per_capture`` times per conv and capture step (once per microbatch
    with ``--stats-all-microbatches``) and, under the inverse method's dense
    apply, no launch of kernels 3 and 4."""
    import torch

    from kfac_pytorch_tpu_torch.models import cifar_resnet

    out = conv_expected_launches(
        hist, cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0)), device,
        bf16)
    out["compute_a_conv_fused"] *= a_per_capture
    if not apply_kernels:
        out["fused_precondition_stack"] = out["fused_sgd_apply"] = 0
    return out


def _tree_equal(got, want, where=""):
    """Every tensor of ``got`` bitwise equal to ``want``'s, same structure."""
    import torch

    if isinstance(want, torch.Tensor):
        if not (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and torch.equal(got.detach(), want)):
            raise AssertionError(f"restored {where} differs from the saved tensor")
        return 1
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"restored {where} has keys {sorted(got)}, saved {sorted(want)}")
        return sum(_tree_equal(got[k], want[k], f"{where}/{k}") for k in want)
    if got != want:
        raise AssertionError(f"restored {where} = {got}, saved {want}")
    return 0


def cifar_phases(device, counters, eigen_stats):
    """Phases 16a–16f: the CIFAR-10 main path with data, evaluation,
    checkpoints, logs and diagnostics; its resume; the inverse method; the
    diagonal blocks; gradient accumulation. Returns what they measured and
    the launches of each path."""
    import os
    import shutil
    import tempfile

    import torch

    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt

    out, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_") as tmp:
        mark("16a. CIFAR-10 set")
        t0 = time.perf_counter()
        data_dir = write_cifar_set(os.path.join(tmp, "data"))
        out["write_set_s"] = time.perf_counter() - t0

        mark("16b. CIFAR-10 recipe with data")
        # deterministic cuDNN for 16b and 16c, so that the resume can be
        # held to the uninterrupted run step for step
        cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        logs, full_dir = os.path.join(tmp, "logs"), os.path.join(tmp, "full")
        full, launches["recipe"] = counted(lambda: trainer.main(cifar_args(
            data_dir, ["--epochs", str(CIFAR_EPOCHS), "--log-dir", logs,
                       "--checkpoint-dir", full_dir])), counters)
        first, last = gate_falling(full["loss"], "CIFAR-10 recipe")
        if len(full["loss"]) != CIFAR_EPOCHS * CIFAR_STEPS:
            raise AssertionError(f"{len(full['loss'])} steps, {CIFAR_EPOCHS} x {CIFAR_STEPS} asked")
        if full["val_count"] != [CIFAR_TEST] * CIFAR_EPOCHS:
            raise AssertionError(f"validation counted {full['val_count']} of {CIFAR_TEST} images")
        nus, eigs = full["kfac_nu"], full["kfac_min_damped_eig"]
        if not all(0.0 < v <= 1.0 for v in nus):
            raise AssertionError(f"nu outside (0, 1]: {min(nus)} .. {max(nus)}")
        damping = trainer.parse_args(cifar_args(data_dir)).damping
        if not min(eigs) >= damping * (1 - 1e-6):
            raise AssertionError(f"min damped eigenvalue {min(eigs)} below damping {damping}")
        with open(os.path.join(logs, "scalars.jsonl")) as fh:
            tags = {json.loads(line)["tag"] for line in fh}
        if tags != CIFAR_TAGS:
            raise AssertionError(f"scalars.jsonl tags {sorted(tags)}, want {sorted(CIFAR_TAGS)}")
        gate_launches(launches["recipe"], cifar_expected_launches(full, device), "CIFAR-10 recipe")
        stats = step_stats(full, BATCH)
        print(f"CIFAR-10 recipe: validation accuracy per epoch {full['val_accuracy']} "
              f"(not gated: warm-up)", flush=True)
        out["recipe"] = {
            "loss_first5": first, "loss_last5": last, "val_loss": full["val_loss"],
            "val_accuracy": full["val_accuracy"], "val_count": full["val_count"],
            "capture_step_ms_median": stats["capture_ms_median"],
            "refresh_step_ms_median": stats["refresh_ms_median"],
            "images_per_s": stats["per_s"],
            "eval_ms": full["eval_ms"], "checkpoint_save_ms": full["checkpoint_ms"],
            "nu_min": min(nus), "min_damped_eig_min": min(eigs),
        }

        mark("16c. CIFAR-10 resume")
        saved = torch.load(ckpt.checkpoint_path(full_dir, 0), map_location=device,
                           weights_only=True)
        _, _, fresh, _ = trainer.build(trainer.parse_args(cifar_args(data_dir)), device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        restored = ckpt.restore_checkpoint(full_dir, 0, fresh)
        torch.cuda.synchronize(device)
        restore_ms = (time.perf_counter() - t0) * 1e3
        n_tensors = (_tree_equal(restored.model.state_dict(), saved["model"], "model")
                     + _tree_equal(restored.opt_state, saved["opt_state"], "opt_state")
                     + _tree_equal(restored.kfac_state, saved["kfac_state"], "kfac_state"))
        del fresh, restored, saved
        cut_dir = os.path.join(tmp, "cut")
        os.makedirs(cut_dir)
        shutil.copy(ckpt.checkpoint_path(full_dir, 0), cut_dir)
        resumed = trainer.main(cifar_args(
            data_dir, ["--epochs", str(CIFAR_EPOCHS), "--checkpoint-dir", cut_dir]))
        if (len(resumed["loss"]) != CIFAR_STEPS or resumed["val_count"] != [CIFAR_TEST]
                or len(resumed["restore_ms"]) != 1):
            raise AssertionError(f"the resumed run took {len(resumed['loss'])} steps and "
                                 f"counted {resumed['val_count']}")
        pairs = [*zip(resumed["loss"], full["loss"][CIFAR_STEPS:]),
                 (resumed["val_loss"][0], full["val_loss"][1]),
                 (resumed["val_accuracy"][0], full["val_accuracy"][1])]
        rel = [abs(a - b) / abs(b) for a, b in pairs]
        if not max(rel) <= RESUME_RTOL:
            i = max(range(len(rel)), key=rel.__getitem__)
            raise AssertionError(f"resumed epoch 1 differs from the uninterrupted run's: "
                                 f"value {i} of {len(rel)} (losses, then validation loss and "
                                 f"accuracy) {pairs[i][0]} vs {pairs[i][1]} "
                                 f"(tolerance {RESUME_RTOL})")
        bitwise = sum(a == b for a, b in pairs)
        out["resume"] = {
            "restored_tensors_bitwise": n_tensors, "restore_ms": restore_ms,
            "trainer_restore_ms": resumed["restore_ms"],
            "epoch1_max_rel_diff": max(rel), "epoch1_values_bitwise": bitwise,
            "epoch1_values": len(pairs), "tolerance": RESUME_RTOL,
        }
        print(f"resume: {n_tensors} restored tensors equal the saved ones bitwise; epoch 1 "
              f"resumed from checkpoint-0: {bitwise} of {len(pairs)} values (losses, validation "
              f"loss and accuracy) bitwise equal to the uninterrupted run's, the largest "
              f"difference {max(rel):.3e} relative", flush=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags

    mark("16d. inverse method")
    inv, launches["inverse"] = counted(lambda: train(["--precond-method", "inverse"]), counters)
    gate_falling(inv["loss"], "inverse-method")
    gate_launches(launches["inverse"], cifar_expected_launches(inv, device, apply_kernels=False),
                  "inverse-method")
    inv_oracle = train(["--precond-method", "inverse", "--factor-kernel", "dense",
                        "--steps-per-epoch", str(ORACLE_STEPS)])["loss"]
    inv_stats = step_stats(inv, BATCH)
    out["inverse"] = {
        "oracle_max_rel_diff": gate_oracle(inv["loss"], inv_oracle, "inverse-method",
                                           range(ORACLE_STEPS)),
        "capture_step_ms_median": inv_stats["capture_ms_median"],
        "refresh_step_ms_median": inv_stats["refresh_ms_median"],
        "eigen_capture_step_ms_median": eigen_stats["capture_ms_median"],
        "eigen_refresh_step_ms_median": eigen_stats["refresh_ms_median"],
    }
    print(f"inverse method: refresh step {inv_stats['refresh_ms_median']:.2f} ms, capture step "
          f"{inv_stats['capture_ms_median']:.2f} ms (eigen: {eigen_stats['refresh_ms_median']:.2f}, "
          f"{eigen_stats['capture_ms_median']:.2f})", flush=True)

    mark("16e. diagonal blocks")
    blocks = ("--diag-blocks", "4", "--diag-warmup", "1")
    spe = 10  # refreshes at steps 0 (one block, epoch 0), 10 (four blocks, epoch 1)
    blk, launches["blocks"] = counted(
        lambda: train([*blocks, "--epochs", "2", "--steps-per-epoch", str(spe)]), counters)
    gate_falling(blk["loss"], "diag-blocks")
    gate_launches(launches["blocks"], cifar_expected_launches(blk, device), "diag-blocks")
    k_losses, o_losses = one_step_oracle(resnet_setup, device, spe + ORACLE_STEPS, blocks, spe)
    blk_stats = step_stats(blk, BATCH)
    out["blocks"] = {
        "oracle_max_rel_diff": gate_oracle(k_losses, o_losses, "diag-blocks", [
            *range(ORACLE_STEPS), *range(spe, spe + ORACLE_STEPS)]),
        "oracle": "each oracle step from the kernel path's state, first 5 steps of each epoch",
        "capture_step_ms_median": blk_stats["capture_ms_median"],
        "refresh_step_ms_median": blk_stats["refresh_ms_median"],
    }

    mark("16f. gradient accumulation")
    out["accumulation"] = {}
    for mode, extra, per_capture in (("last", [], 1), ("all", ["--stats-all-microbatches"], 2)):
        acc_flags = ["--batches-per-allreduce", "2", *extra]
        acc, launches[f"accum_{mode}"] = counted(
            lambda: train([*acc_flags, "--steps-per-epoch", "10"]), counters)
        gate_falling(acc["loss"], f"accumulation ({mode})")
        gate_launches(launches[f"accum_{mode}"],
                      cifar_expected_launches(acc, device, a_per_capture=per_capture),
                      f"accumulation ({mode})")
        acc_oracle = train([*acc_flags, "--steps-per-epoch", str(ORACLE_STEPS),
                            "--factor-kernel", "dense", "--apply-kernel", "dense"])["loss"]
        acc_stats = step_stats(acc, 2 * BATCH)
        out["accumulation"][mode] = {
            "oracle_max_rel_diff": gate_oracle(acc["loss"], acc_oracle, f"accumulation ({mode})",
                                               range(ORACLE_STEPS)),
            "kernel1_per_capture_step": launches[f"accum_{mode}"]["compute_a_conv_fused"]
            / sum(k != "plain" for k in acc["kind"]),
            "capture_step_ms_median": acc_stats["capture_ms_median"],
        }
    out["launches"] = launches
    return out


def bf16_resnet_phase(device, counters, f32_stats):
    """Phase 17a: ResNet-32 through the CIFAR twin with ``--bf16
    --eigen-dtype bf16`` on the synthetic batches of phase 4: the loss
    finite and falling, every counter as the run implies (kernel 1 on its
    bf16 route for every conv but the stem, kernel 3 on its bf16-Q route,
    kernel 4 once a step), each of the first 5 oracle steps (``"dense"`` in
    the same modes, from the kernel path's state) within
    ``BF16_ORACLE_RTOL``; step medians beside phase 4's float32 ones."""
    hist, launches = counted(lambda: train(BF16_FLAGS), counters)
    first, last = gate_falling(hist["loss"], "ResNet-32 bf16")
    gate_launches(launches, cifar_expected_launches(hist, device, bf16=True), "ResNet-32 bf16")
    kernel, oracle = one_step_oracle(resnet_setup, device, ORACLE_STEPS, BF16_FLAGS)
    rel = gate_oracle(kernel, oracle, "ResNet-32 bf16", range(ORACLE_STEPS), BF16_ORACLE_RTOL)
    stats = step_stats(hist, BATCH)
    return {
        "path": f"{MODEL} batch {BATCH}, {STEPS} steps, {' '.join(BF16_FLAGS)}",
        "loss_first5": first, "loss_last5": last,
        "one_step_oracle": {"kernel": kernel, "oracle": oracle, "max_rel_diff": rel,
                            "tolerance": f"{BF16_ORACLE_RTOL} relative per step"},
        "capture_step_ms_median": stats["capture_ms_median"],
        "refresh_step_ms_median": stats["refresh_ms_median"],
        "images_per_s": stats["per_s"],
        "f32_capture_step_ms_median": f32_stats["capture_ms_median"],
        "f32_refresh_step_ms_median": f32_stats["refresh_ms_median"],
        "f32_images_per_s": f32_stats["per_s"],
        "launches": launches,
    }


def bf16_imagenet_phase(device, counters, f32_stats):
    """Phase 17b, this slice's path: ResNeXt-50 32x4d at batch 32, 224x224,
    with ``--bf16 --eigen-dtype bf16`` through the ImageNet twin for
    ``IMAGENET_STEPS`` steps: the loss finite and falling, every counter as
    the run implies (kernel 1 bf16 on every ungrouped conv but the stem,
    kernel 1g bf16, kernel 3 bf16-Q, kernel 4), the one-step oracle within
    ``BF16_ORACLE_RTOL``, images/s and step medians beside phase 12's
    float32 ones, and a profiled window of 3 capture steps."""
    import torch

    from kfac_pytorch_tpu_torch.models import imagenet_resnet

    hist, launches = counted(
        lambda: train_imagenet([*BF16_FLAGS, "--steps-per-epoch", str(IMAGENET_STEPS)]), counters)
    first, last = gate_falling(hist["loss"], "ResNeXt bf16")
    structure = imagenet_resnet.get_model(IMAGENET_MODEL, generator=torch.Generator().manual_seed(0))
    gate_launches(launches, conv_expected_launches(hist, structure, device, bf16=True),
                  "ResNeXt bf16")
    del structure
    kernel, oracle = one_step_oracle(imagenet_setup, device, ORACLE_STEPS, BF16_FLAGS)
    rel = gate_oracle(kernel, oracle, "ResNeXt bf16", range(ORACLE_STEPS), BF16_ORACLE_RTOL)
    profile = profile_path(imagenet_setup, device, [
        ((*BF16_FLAGS, "--steps-per-epoch", "5"), [("capture", 2, 5)])])
    gate_profile_launches(profile, "imagenet")
    stats = step_stats(hist, IMAGENET_BATCH)
    return {
        "path": (f"{IMAGENET_MODEL} batch {IMAGENET_BATCH}, 224x224, {IMAGENET_STEPS} steps, "
                 f"{' '.join(BF16_FLAGS)}"),
        "loss_first5": first, "loss_last5": last,
        "one_step_oracle": {"kernel": kernel, "oracle": oracle, "max_rel_diff": rel,
                            "tolerance": f"{BF16_ORACLE_RTOL} relative per step"},
        "capture_step_ms_median": stats["capture_ms_median"],
        "refresh_step_ms_median": stats["refresh_ms_median"],
        "images_per_s": stats["per_s"],
        "f32_capture_step_ms_median": f32_stats["capture_ms_median"],
        "f32_refresh_step_ms_median": f32_stats["refresh_ms_median"],
        "f32_images_per_s": f32_stats["per_s"],
        "profile": profile,
        "launches": launches,
    }


def precision_phase(device):
    """Phase 17c: ``--precond-precision default`` (one TF32 pass in the
    dense products) on the ResNet-32 inverse method: its first 10 losses
    within ``PRECISION_RTOL`` of IEEE float32's; on one refresh's inverses
    and random gradients of every layer, ``precondition_all_inv`` at
    ``"default"`` within ``PRECISION_RTOL`` of ``"highest"`` per layer; a
    1024² float32 product inside the precision context differs from the
    IEEE one (TF32 on), and after it, is IEEE again (the flag restored)."""
    import torch

    from kfac_pytorch_tpu_torch.device import rotation_precision
    from kfac_pytorch_tpu_torch.ops import precondition as pc
    from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step

    flags = ["--precond-method", "inverse", "--steps-per-epoch", "10"]
    ieee = train(flags)["loss"]
    tf32 = train([*flags, "--precond-precision", "default"])["loss"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(tf32, ieee))
    if not loss_rel <= PRECISION_RTOL:
        raise AssertionError(f"--precond-precision default: losses {tf32} vs IEEE {ieee}")
    step_fn, state, kfac, batches, args = resnet_setup(
        device, ("--precond-method", "inverse", "--steps-per-epoch", "1"))
    state, _ = step_fn(state, batches[0], args.base_lr, args.damping,
                       **kfac_flags_for_step(0, kfac, 0))
    ks = state.kfac_state
    gen = torch.Generator(device=device).manual_seed(7)
    gmats = {n: torch.randn(f["G"].shape[0], f["A"].shape[0], device=device, generator=gen)
             for n, f in ks["factors"].items()}
    hi = pc.precondition_all_inv(gmats, ks["eigen"], ks["eigen_stacked"], "highest")
    lo = pc.precondition_all_inv(gmats, ks["eigen"], ks["eigen_stacked"], "default")
    layer_rel = {n: float((lo[n] - hi[n]).abs().max() / hi[n].abs().max()) for n in hi}
    if not max(layer_rel.values()) <= PRECISION_RTOL:
        raise AssertionError(f"--precond-precision default moved an update by "
                             f"{max(layer_rel.values()):.3e} relative, bound {PRECISION_RTOL}")
    a = torch.randn(1024, 1024, device=device, generator=gen)
    exact = (a.double() @ a.double())

    def err(prod):
        return float((prod.double() - exact).abs().max() / exact.abs().max())

    with rotation_precision("default"):
        tf32_err = err(a @ a)
    ieee_err = err(a @ a)
    if torch.backends.cuda.matmul.allow_tf32 or not ieee_err < tf32_err or not ieee_err <= 1e-5:
        raise AssertionError(f"the precision context: TF32 product error {tf32_err:.3e}, after it "
                             f"{ieee_err:.3e} (allow_tf32 {torch.backends.cuda.matmul.allow_tf32})")
    return {
        "losses_default": tf32, "losses_ieee": ieee, "loss_max_rel_diff": loss_rel,
        "update_max_rel_diff": max(layer_rel.values()),
        "tolerance": f"{PRECISION_RTOL} relative (losses; each layer's update over its largest entry)",
        "product_1024_rel_err": {"default": tf32_err, "after_the_context": ieee_err},
    }


def _resume_from_first(main, argv, tmp, name, epochs=2):
    """``main`` for ``epochs`` epochs with a checkpoint directory, then again
    from only its ``checkpoint-0``: ``(uninterrupted history, resumed
    history)``."""
    import os
    import shutil

    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt

    full, cut = os.path.join(tmp, f"{name}_full"), os.path.join(tmp, f"{name}_cut")
    whole = main([*argv, "--epochs", str(epochs), "--checkpoint-dir", full])
    os.makedirs(cut)
    shutil.copy(ckpt.checkpoint_path(full, 0), cut)
    resumed = main([*argv, "--epochs", str(epochs), "--checkpoint-dir", cut])
    if len(resumed["restore_ms"]) != 1:
        raise AssertionError(f"{name}: the rerun did not resume from checkpoint-0")
    return whole, resumed


def _gate_resume(pairs, path):
    rel = [abs(a - b) / abs(b) for a, b in pairs]
    if not rel or not max(rel) <= RESUME_RTOL:
        raise AssertionError(f"{path}: the resumed epoch differs from the uninterrupted run's: "
                             f"{pairs}")
    return {"values": len(pairs), "bitwise": sum(a == b for a, b in pairs), "max_rel_diff": max(rel)}


def _tags(log_dir):
    import os

    with open(os.path.join(log_dir, "scalars.jsonl")) as fh:
        return {json.loads(line)["tag"] for line in fh}


def bookkeeping_phase(device, counters):
    """Phase 17d: the ImageNet and LM twins' bookkeeping. ImageNet at a
    reduced depth (``IMAGENET_BOOK_ARGS``: ResNet-18 at 64x64, batch 32):
    ``--log-dir`` (the JAX trainer's tags) and ``--checkpoint-dir`` for 2
    epochs of ``BOOK_STEPS`` steps, then epoch 1 resumed from checkpoint-0
    within ``RESUME_RTOL`` of the uninterrupted run (deterministic cuDNN);
    ``--batches-per-allreduce 2`` (kernel 1 once per conv and capture step)
    and ``--precond-method inverse`` (kernels 3 and 4 never), their
    counters as implied. The LM at its path's widths: ``--log-dir`` with
    ``--kfac-diagnostics`` (the JAX trainer's tags) and
    ``--checkpoint-dir`` for 2 epochs of ``LM_BOOK_STEPS`` steps, then
    epoch 1 resumed within ``RESUME_RTOL``."""
    import os
    import tempfile

    import torch

    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as im_trainer
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm_trainer
    from kfac_pytorch_tpu_torch.models import imagenet_resnet
    from kfac_pytorch_tpu_torch.observability.diagnostics import SCALAR_KEYS

    out, launches = {}, {}
    structure = imagenet_resnet.get_model("resnet18", generator=torch.Generator().manual_seed(0))
    book = [*IMAGENET_BOOK_ARGS, "--steps-per-epoch", str(BOOK_STEPS)]
    with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_book_") as tmp:
        cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        logs = os.path.join(tmp, "logs")
        (whole, resumed), launches["imagenet_book"] = counted(
            lambda: _resume_from_first(im_trainer.main, [*book, "--log-dir", logs], tmp,
                                       "imagenet"), counters)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
        if not all(math.isfinite(v) for v in whole["loss"]):
            raise AssertionError(f"ImageNet bookkeeping: non-finite loss {whole['loss']}")
        both = {"loss": whole["loss"] + resumed["loss"], "kind": whole["kind"] + resumed["kind"]}
        gate_launches(launches["imagenet_book"], conv_expected_launches(both, structure, device),
                      "ImageNet bookkeeping")
        tags = _tags(logs)
        if tags != {"train/loss", "train/accuracy", "train/lr"}:
            raise AssertionError(f"ImageNet scalars.jsonl tags {sorted(tags)}")
        out["imagenet_resume"] = _gate_resume(
            list(zip(resumed["loss"], whole["loss"][BOOK_STEPS:])), "ImageNet resume")
        out["imagenet_tags"] = sorted(tags)

        for name, extra, apply_kernels in (("accumulation", ["--batches-per-allreduce", "2"], True),
                                           ("inverse", ["--precond-method", "inverse"], False)):
            hist, launches[f"imagenet_{name}"] = counted(
                lambda: im_trainer.main([*book, "--epochs", "1", *extra]), counters)
            if not all(math.isfinite(v) for v in hist["loss"]):
                raise AssertionError(f"ImageNet {name}: non-finite loss {hist['loss']}")
            want = conv_expected_launches(hist, structure, device)
            if not apply_kernels:
                want["fused_precondition_stack"] = want["fused_sgd_apply"] = 0
            gate_launches(launches[f"imagenet_{name}"], want, f"ImageNet {name}")
            out[f"imagenet_{name}"] = {"losses": hist["loss"],
                                       "capture_step_ms_median": step_stats(
                                           hist, IMAGENET_BATCH)["capture_ms_median"]}

        lm_logs = os.path.join(tmp, "lm_logs")
        lm_argv = [*LM_ARGS, "--steps-per-epoch", str(LM_BOOK_STEPS), "--kfac-diagnostics",
                   "--log-dir", lm_logs]
        whole, resumed = _resume_from_first(lm_trainer.main, lm_argv, tmp, "lm")
        if not all(math.isfinite(v) for v in whole["loss"] + whole["val_loss"]):
            raise AssertionError(f"LM bookkeeping: non-finite loss {whole['loss']}")
        want_tags = ({"train/loss", "train/ppl", "val/loss", "val/ppl"}
                     | {f"kfac/{k}_mean" for k in (*SCALAR_KEYS, "cond_max")})
        tags = _tags(lm_logs)
        if tags != want_tags:
            raise AssertionError(f"LM scalars.jsonl tags {sorted(tags)}, want {sorted(want_tags)}")
        out["lm_resume"] = _gate_resume(
            [*zip(resumed["loss"], whole["loss"][LM_BOOK_STEPS:]),
             (resumed["val_loss"][0], whole["val_loss"][1])], "LM resume")
        out["lm_tags"] = sorted(tags)
        out["lm_nu"] = whole["kfac_nu"]
    out["launches"] = launches
    return out


# The ImageNet data path (phases 18a-d): uint8 shards written from the
# learnable stand-in (``synthetic_imagenet_like``, 200 classes) stored at
# 256x256, 320 train and 200 val images (~102 MB), trained through the twin
# on ResNet-50 at the JAX trainer's per-device recipe (batch 32, 224x224,
# RandomResizedCrop + flip) for one epoch of 10 steps, the whole val split
# evaluated after it in batches of 64 (200 = 3 x 64 + 8: a ragged last
# batch). The other train modes take 3 steps each: --no-augment on the
# 256x256 shards (Resize + CenterCrop) and shards stored at 224x224 (pass
# through).
SHARD_MODEL = "resnet50"
SHARD_TRAIN, SHARD_VAL, SHARD_SIZE = 320, 200, 256
SHARD_STEPS = 10
SHARD_VAL_BATCH = 64
SHARD_MODE_STEPS = 3


def write_imagenet_shards(root, n_train, n_val, size, seed=0):
    """``{train,val}_{x,y}.npy`` in ``root``: NHWC uint8 images of the
    learnable stand-in stored at ``size`` x ``size``, int32 labels
    (``scripts/make_imagenet_shards.py``'s layout)."""
    import os

    import numpy as np

    from kfac_pytorch_tpu_torch.training import data as data_lib

    os.makedirs(root)
    (x, y), (xv, yv) = data_lib.synthetic_imagenet_like(
        size=size, n_train=n_train, n_val=n_val, seed=seed)
    for name, a in (("train_x", x), ("train_y", y), ("val_x", xv), ("val_y", yv)):
        np.save(os.path.join(root, f"{name}.npy"), a)
    return root


def shard_args(data_dir, extra=()):
    """The shard path's flags: the numpy pipeline (``--num-workers 0``, run
    Q's serial transform) unless ``extra`` says otherwise."""
    return ["--data-dir", data_dir, "--model", SHARD_MODEL, "--batch-size", str(IMAGENET_BATCH),
            "--image-size", "224", "--val-batch-size", str(SHARD_VAL_BATCH), "--epochs", "1",
            "--seed", "0", "--device", "cuda", "--num-workers", "0", *extra]


def _kept_build(module, kept):
    """``module.build`` wrapped so that the model and K-FAC it builds and the
    first and last states its train step returns land in ``kept``; restore
    it with ``module.build = kept["build"]``."""
    build = kept["build"] = module.build

    def keep(*args, **kwargs):
        model, kfac, state, step = build(*args, **kwargs)
        kept.update(model=model, kfac=kfac, state=state)

        def step_kept(*a, **k):
            out = step(*a, **k)
            kept.setdefault("first_state", out[0])
            kept["state"] = out[0]
            return out

        return model, kfac, state, step_kept

    module.build = keep


def imagenet_data_phases(device, counters, tmp):
    """Phases 18a-d: the ImageNet shard path through the twin (counters
    zeroed just before each run), ``examples/evaluate.py`` and
    ``--init-from-torch``, the shards written under ``tmp`` (they outlive
    these phases: phase 20a reads them). Returns what
    they measured, the launches of each path, kernel 1's row at ResNet-50's
    convs and the directory of the 256x256 shards."""
    import os

    import numpy as np
    import torch

    from kfac_pytorch_tpu_torch.examples import evaluate
    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as trainer
    from kfac_pytorch_tpu_torch.models import imagenet_resnet
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt

    out, launches = {}, {}
    structure = imagenet_resnet.get_model(SHARD_MODEL, generator=torch.Generator().manual_seed(0))
    mark("18a. ImageNet shards")
    t0 = time.perf_counter()
    d256 = write_imagenet_shards(os.path.join(tmp, "s256"), SHARD_TRAIN, SHARD_VAL, SHARD_SIZE)
    d224 = write_imagenet_shards(os.path.join(tmp, "s224"), IMAGENET_BATCH * SHARD_MODE_STEPS,
                                 IMAGENET_BATCH, 224, seed=1)
    out["write_shards_s"] = time.perf_counter() - t0
    out["shard_mb"] = sum(os.path.getsize(os.path.join(d256, f)) for f in os.listdir(d256)) / 1e6

    mark("18b. ImageNet twin on the shards")
    # deterministic cuDNN for 18b and 18d: evaluate.py must repeat 18b's
    # validation from its checkpoint
    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    ck = os.path.join(tmp, "ck")
    hist, launches["shards_rrc"] = counted(lambda: trainer.main(shard_args(
        d256, ["--steps-per-epoch", str(SHARD_STEPS), "--checkpoint-dir", ck])), counters)
    if not all(math.isfinite(v) for v in hist["loss"] + hist["val_loss"]):
        raise AssertionError(f"ImageNet shards: non-finite loss {hist['loss']} {hist['val_loss']}")
    if len(hist["loss"]) != SHARD_STEPS or hist["val_count"] != [SHARD_VAL]:
        raise AssertionError(f"ImageNet shards: {len(hist['loss'])} steps, validation counted "
                             f"{hist['val_count']} of {SHARD_VAL} images")
    gate_launches(launches["shards_rrc"], conv_expected_launches(hist, structure, device),
                  "ImageNet shards")
    stats = step_stats(hist, IMAGENET_BATCH)
    out["rrc"] = {
        "losses": hist["loss"], "val_loss": hist["val_loss"][0],
        "val_accuracy": hist["val_accuracy"][0], "val_count": hist["val_count"][0],
        "transform_ms_per_batch_median": statistics.median(hist["transform_ms"]),
        "transform_ms_per_batch": hist["transform_ms"],
        "step0_ms": stats["step0_ms"],
        "capture_step_ms_median": stats["capture_ms_median"],
        "refresh_step_ms_median": stats.get("refresh_ms_median"),
        "images_per_s_steps_only": stats["per_s"],
        "images_per_s_with_transform": IMAGENET_BATCH * (SHARD_STEPS - 1) / (
            (sum(hist["step_ms"][1:]) + sum(hist["transform_ms"][1:])) / 1e3),
        "eval_ms": hist["eval_ms"][0],
        "eval_ms_per_image": hist["eval_ms"][0] / SHARD_VAL,
    }

    mark("18c. --no-augment and shards stored at 224x224")
    for mode, data_dir, extra in (("centercrop", d256, ["--no-augment"]),
                                  ("none", d224, ["--no-augment"])):
        x = np.load(os.path.join(data_dir, "train_x.npy"), mmap_mode="r")
        if trainer.train_mode(x, 224, False) != mode:
            raise AssertionError(f"{data_dir}: train mode {trainer.train_mode(x, 224, False)}, "
                                 f"want {mode}")
        h, launches[f"shards_{mode}"] = counted(lambda: trainer.main(shard_args(
            data_dir, ["--steps-per-epoch", str(SHARD_MODE_STEPS), *extra])), counters)
        if len(h["loss"]) != SHARD_MODE_STEPS or not all(
                math.isfinite(v) for v in h["loss"] + h["val_loss"]):
            raise AssertionError(f"ImageNet shards, {mode}: losses {h['loss']} {h['val_loss']}")
        gate_launches(launches[f"shards_{mode}"], conv_expected_launches(h, structure, device),
                      f"ImageNet shards, {mode}")
        out[mode] = {"losses": h["loss"], "val_loss": h["val_loss"][0],
                     "val_count": h["val_count"][0],
                     "transform_ms_per_batch_median": statistics.median(h["transform_ms"])}

    mark("18d. evaluate.py and --init-from-torch")
    common = ["--data-dir", d256, "--model", SHARD_MODEL, "--batch-size", str(SHARD_VAL_BATCH),
              "--device", "cuda", "--num-workers", "0"]
    t0 = time.perf_counter()
    ev = evaluate.main([*common, "--checkpoint-dir", ck])
    evaluate_s = time.perf_counter() - t0
    want = (hist["val_loss"][0], hist["val_accuracy"][0])
    sd = ckpt.restore_weights_only(ck, 0)
    ref = os.path.join(tmp, "resnet50_ref.pth")
    torch.save({"model": sd, "epoch": 0}, ref)
    ev_torch = evaluate.main([*common, "--init-from-torch", ref])
    for name, got in (("--checkpoint-dir", ev), ("--init-from-torch", ev_torch)):
        rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want))
        if not rel <= RESUME_RTOL:
            raise AssertionError(f"evaluate.py {name}: loss, accuracy {got}, the twin's last "
                                 f"validation {want}")
    kept = {}
    _kept_build(trainer, kept)
    try:
        trainer.main(shard_args(d256, ["--init-from-torch", ref, "--epochs", "0"]))
    finally:
        trainer.build = kept["build"]
    loaded = kept["model"].state_dict()
    same = [torch.equal(loaded[k].cpu(), v) for k, v in sd.items()
            if not k.endswith("num_batches_tracked")]
    if not all(same):
        raise AssertionError(f"--init-from-torch: {len(same) - sum(same)} of {len(same)} "
                             "entries differ from the file")
    del kept, loaded
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    out["evaluate"] = {"checkpoint_dir": ev, "init_from_torch": ev_torch, "twin": want,
                       "bitwise": [tuple(ev) == want, tuple(ev_torch) == want],
                       "evaluate_s": evaluate_s, "init_from_torch_entries_bitwise": len(same)}
    print(f"evaluate.py reproduces the twin's validation (loss, accuracy) {want} from its "
          f"checkpoint {ev} and from a torchvision-format file {ev_torch}; the twin's "
          f"--init-from-torch loads all {len(same)} entries bitwise", flush=True)

    # kernel 1 at ResNet-50's convs, on a batch the shard path gives it
    xb, _ = next(trainer.shard_batches(
        np.load(os.path.join(d256, "train_x.npy"), mmap_mode="r"),
        np.load(os.path.join(d256, "train_y.npy")), IMAGENET_BATCH, 1, "rrc", 224, 256, 0, []))
    model = structure.to(device)
    conv_a = conv_a_phase(model, torch.from_numpy(xb).to(device))
    conv_a["launches"] = launches["shards_rrc"]["compute_a_conv_fused"]
    conv_a["launches_per_step"] = conv_a["launches"] / SHARD_STEPS
    del model, structure
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out, conv_a, d256


# The WikiText LSTM (phases 19a-d): the JAX trainer's recipe at full width
# (2-layer LSTM, 650 wide, dropout 0.5, batch 20, BPTT 35, lr 20, clip 0.25,
# momentum 0), K-FAC on the decoder every 10 steps, on the synthetic corpus
# (vocab 1,000) for 30 steps and one validation pass; then a
# WikiText-2-sized vocabulary of 33,278 written to token files (3 steps:
# one refresh with an eigh of the 33,278-wide G factor, 2 capture steps).
WIKITEXT_ARGS = [
    "--synthetic", "--model", "LSTM", "--emsize", "650", "--nhid", "650", "--nlayers", "2",
    "--dropout", "0.5", "--batch-size", "20", "--bptt", "35", "--base-lr", "20",
    "--clip", "0.25", "--kfac-update-freq", "10", "--epochs", "1", "--seed", "0",
    "--device", "cuda",
]
WIKITEXT_STEPS = 30
WIKITEXT2_VOCAB = 33278
WIKITEXT2_STEPS = 3
# the tied head, the other cells and the resume: steps per run
WIKITEXT_TIED_STEPS = 10
WIKITEXT_CELL_STEPS = 5
WIKITEXT_BOOK_STEPS = 3
# the transformer LM with the tied head: the LM cell's widths, 2 layers
LM_TIED_EXTRA = ["--n-layers", "2", "--tie-embeddings"]
LM_TIED_STEPS = 5


def write_wikitext(root, vocab, n_train, n_valid, n_test, seed=0):
    """``wiki.{train,valid,test}.tokens`` whose words make a vocabulary of
    exactly ``vocab`` entries (``<unk>`` and ``<eos>`` among them): every
    word once in the train file, then a Zipf mix over all of them, in lines
    of 20 words."""
    import os

    import numpy as np

    os.makedirs(root)
    r = np.random.RandomState(seed)
    words = np.array([f"w{i}" for i in range(vocab - 2)])
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    for split, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        ids = r.choice(len(words), size=n, p=p)
        if split == "train":
            ids = np.concatenate([r.permutation(len(words)), ids])
        with open(os.path.join(root, f"wiki.{split}.tokens"), "w", encoding="utf-8") as fh:
            for lo in range(0, len(ids), 20):
                fh.write(" ".join(words[ids[lo:lo + 20]]) + " \n")
    return root


def train_wikitext(extra):
    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer

    return trainer.main([*WIKITEXT_ARGS, *extra])


def wikitext_setup(device, extra=()):
    """The WikiText path through the library API (the twin's ``build`` and
    its train step with the carry threaded and the dropout generator of
    epoch 0), as ``profile_path`` takes it: ``(step_fn, state, kfac,
    batches, args)``."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer
    from kfac_pytorch_tpu_torch.training import data as data_lib
    from kfac_pytorch_tpu_torch.training.lm_step import init_carry

    args = trainer.parse_args([*WIKITEXT_ARGS, *extra])
    splits, vocab = trainer.load_corpus(args)
    model, kfac, state, step = trainer.build(args, len(vocab), device)
    stream = data_lib.batchify_tokens(splits["train"], args.batch_size)
    batches = [trainer.device_batch(x, y, device)
               for x, y in data_lib.bptt_batches(stream, args.bptt)][:WIKITEXT_STEPS]
    carry = [init_carry(model, args.batch_size, device)]
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def step_fn(state, batch, lr, damping, **flags):
        state, carry[0], m = step(state, batch, carry[0], gen, lr, damping, **flags)
        return state, m

    return step_fn, state, kfac, batches, args


def wikitext_expected(hist, groups=1, embedding=False):
    """What a WikiText run implies: kernel 3 once per K-FAC step per shape
    group of dense layers (the untied decoder: one), kernel 4 once per
    K-FAC step, kernel 2 once per capture step with ``--kfac-embedding``."""
    steps = len(hist["loss"])
    captures = sum(k != "plain" for k in hist["kind"])
    out = {"fused_precondition_stack": groups * steps, "fused_sgd_apply": steps}
    if embedding:
        out["compute_a_embed_fused"] = captures
    return out


def wide_apply_phase(kfac_state, device):
    """Kernel 3 at the WikiText-2 decoder's width: ``QG`` the 33,278-wide
    eigenbasis that the run's refresh wrote, against its plain version
    within 1e-4 of the largest plain entry (v and vg), two launches
    bitwise equal, timed with CUDA events (few repeats: one plain call
    moves ~9 GB)."""
    import torch

    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak

    e = kfac_state["eigen"]["decoder"]
    qa, da, qg, dg = (e[k][None].contiguous() for k in ("QA", "dA", "QG", "dG"))
    g, a = qg.shape[1], qa.shape[1]
    gen = torch.Generator(device=device).manual_seed(2)
    gm = torch.randn(1, g, a, device=device, generator=gen)
    lam = torch.full((), 0.003, device=device)
    v, vg = ak.fused_precondition_stack(gm, qa, da, qg, dg, lam)
    v_p, vg_p = ak.fused_precondition_stack_plain(gm, qa, da, qg, dg, lam)
    errs = [scaled_err(v, v_p), scaled_err(vg, vg_p)]
    again = ak.fused_precondition_stack(gm, qa, da, qg, dg, lam)
    if not (torch.equal(v, again[0]) and torch.equal(vg, again[1])):
        raise AssertionError("fused apply kernel at the 33,278-wide decoder: two launches differ")
    rel = max(r for _, r in errs)
    if not rel <= 1e-4:
        raise AssertionError(f"fused apply kernel at the 33,278-wide decoder disagrees with its "
                             f"plain version: rel {rel:.3e} > 1e-4")
    del again, v_p, vg_p
    flops = 4 * g * a * (g + a) + 5 * g * a
    nbytes = 4 * (2 * g * a + a + g + 1 + a * a + g * g)

    def library():
        t = torch.matmul(torch.matmul(qg.transpose(1, 2), gm), qa)
        t = t / (dg[:, :, None] * da[:, None, :] + lam)
        torch.matmul(torch.matmul(qg, t), qa.transpose(1, 2))

    b = bound_ms([(nbytes, flops)], tf32_products=3)
    return {
        "name": "fused_apply (eigenbasis precondition + KL partial)",
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/fused_apply.cu",
        "replaces": "kfac_pytorch_tpu/ops/apply_kernels.py:190",
        "unit": f"the WikiText-2 decoder's group, 1 x [{g}, {a}], QG {g * g * 4 / 1e9:.2f} GB",
        "group": f"1 x [{g}, {a}]",
        "route": ak.fused_apply_route(gm, qa, qg),
        "max_abs_err": max(e for e, _ in errs),
        "max_rel_err": rel,
        "tolerance": "|kernel - plain| <= 1e-4 * max|plain| (v and vg)",
        "ms": time_ms(lambda: ak.fused_precondition_stack(gm, qa, da, qg, dg, lam), reps=3, warmup=1),
        "plain_ms": time_ms(lambda: ak.fused_precondition_stack_plain(gm, qa, da, qg, dg, lam),
                            reps=2, warmup=1),
        "library_ms": time_ms(library, reps=2, warmup=1),
        "library": "batched torch.matmul chain",
        "bound_ms": b[0], "bound_by": b[1],
        "qg_gb": g * g * 4 / 1e9,
    }


def wide_eigh_phase(kfac_state, device):
    """The refresh's decomposition of the decoder's 33,278-wide G factor,
    wider than cuSOLVER's ``syevd`` takes (``ops/eigh.py``'s spectral
    divide and conquer), held to the factor it decomposed in float64 on 256
    random directions ``v`` (a float32 check of a 33,278-long product has a
    rounding floor near 1e-4 of its own): ``|(Q diag(d) Qᵀ − G) v|`` within
    1e-5 of ``max d · |v|``, and ``|Qᵀ Q v − v|`` within 1e-5 of ``|v|``,
    per direction."""
    import torch

    from kfac_pytorch_tpu_torch.ops import eigh as eigh_ops

    e = kfac_state["eigen"]["decoder"]
    g = kfac_state["factors"]["decoder"]["G"]
    n = g.shape[0]
    recon, orth = decomposition_errors(g, e["QG"], e["dG"], device)
    if not (recon <= EIGH_TOL and orth <= EIGH_TOL):
        raise AssertionError(f"eigh of the {n}-wide G factor: reconstruction {recon:.2e}, "
                             f"orthogonality {orth:.2e} (tolerance {EIGH_TOL})")
    return {"n": n, "syevd_max_n": eigh_ops.SYEVD_MAX_N, "reconstruction_rel": recon,
            "orthogonality": orth, "tolerance": EIGH_TOL, "directions": 256}


# an eigendecomposition's reconstruction and orthogonality, relative, in
# float64 on 256 random directions (phases 19b and 20d)
EIGH_TOL = 1e-5


def decomposition_errors(f, q, d, device):
    """``(reconstruction, orthogonality)`` of ``f ≈ Q diag(d) Qᵀ`` in float64
    on 256 random directions ``v`` (a float32 check of a long product has a
    rounding floor of its own): the largest ``|(Q diag(d) Qᵀ − F) v| /
    (max d · |v|)`` and ``|Qᵀ Q w − w| / |w|`` (``w = Qᵀ v``) over the
    directions, ``F`` symmetrized as eigh sees it."""
    import torch

    n = f.shape[0]
    d = d.double()
    v = torch.randn(n, 256, generator=torch.Generator(device=device).manual_seed(3),
                    device=device, dtype=torch.float64)

    def rows(mat, x):  # mat @ x in float64, 4096 rows at a time
        return torch.cat([mat[lo:lo + 4096].double() @ x for lo in range(0, n, 4096)])

    def rows_t(mat, x):  # matᵀ @ x in float64
        return sum(mat[lo:lo + 4096].double().T @ x[lo:lo + 4096] for lo in range(0, n, 4096))

    qtv = rows_t(q, v)
    fv = 0.5 * (rows(f, v) + rows_t(f, v))
    recon = float(((rows(q, d[:, None] * qtv) - fv).norm(dim=0) / v.norm(dim=0)).max())
    recon /= float(d.abs().max())
    orth = float(((rows_t(q, rows(q, qtv)) - qtv).norm(dim=0) / qtv.norm(dim=0)).max())
    return recon, orth


def wikitext_phases(device, counters, flush):
    """Phases 19a-d: the WikiText LSTM twin at the recipe's widths with its
    kernels at their shapes, against its oracle, profiled; at a
    WikiText-2-sized vocabulary; the tied head, the other cells and a
    resume; the transformer LM with the tied head. Returns what they
    measured and the kernel rows (3 at V = 1,000 and 33,278, 4 on the
    LSTM's leaves, 2 on the tied path's ids)."""
    import os
    import tempfile

    import torch

    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm_trainer
    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer
    from kfac_pytorch_tpu_torch.training import data as data_lib

    out, launches, rows = {}, {}, {}
    mark("19a. WikiText LSTM")
    args = trainer.parse_args(WIKITEXT_ARGS)
    splits, vocab = trainer.load_corpus(args)
    model = trainer.build(args, len(vocab), device)[0]
    rows["apply"] = apply_phase(model, device)
    rows["sgd"] = sgd_phase(model, device, args.base_lr, args.momentum, args.wd, flush)
    x, _ = next(data_lib.bptt_batches(data_lib.batchify_tokens(splits["train"], args.batch_size),
                                      args.bptt))
    ids = trainer.device_batch(x, x, device)[0]
    del model
    hist, launches["wikitext"] = counted(
        lambda: train_wikitext(["--steps-per-epoch", str(WIKITEXT_STEPS)]), counters)
    first, last = gate_falling(hist["loss"], "WikiText LSTM")
    if len(hist["val_loss"]) != 1 or not math.isfinite(hist["val_loss"][0]):
        raise AssertionError(f"WikiText validation: {hist['val_loss']}")
    gate_launches(launches["wikitext"], wikitext_expected(hist), "WikiText LSTM")
    dense = train_wikitext(["--steps-per-epoch", str(ORACLE_STEPS), "--apply-kernel", "dense"])
    oracle_rel = gate_oracle(hist["loss"], dense["loss"], "WikiText LSTM", range(ORACLE_STEPS))
    stats = step_stats(hist, args.batch_size * args.bptt)
    out["lstm"] = {
        "loss_first5": first, "loss_last5": last, "val_loss": hist["val_loss"][0],
        "val_ppl": hist["val_ppl"][0], "step0_ms": stats["step0_ms"],
        "capture_step_ms_median": stats["capture_ms_median"],
        "refresh_step_ms_median": stats["refresh_ms_median"], "tokens_per_s": stats["per_s"],
        "oracle_max_rel_diff": oracle_rel,
    }
    for key, fn in (("apply", "fused_precondition_stack"), ("sgd", "fused_sgd_apply")):
        rows[key]["launches"] = launches["wikitext"][fn]
        rows[key]["launches_per_step"] = rows[key]["launches"] / len(hist["loss"])
    profile = profile_path(wikitext_setup, device, [((), [("capture", 1, 10)])])
    gate_profile_launches(profile, "wikitext")
    out["profile"] = profile

    with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_wikitext_") as tmp:
        mark("19b. WikiText-2-sized vocabulary")
        root = write_wikitext(os.path.join(tmp, "wt2"), WIKITEXT2_VOCAB, 60_000, 8_000, 2_000)
        n_vocab = len(data_lib.build_corpus(root)[1])
        if n_vocab != WIKITEXT2_VOCAB:
            raise AssertionError(f"written corpus has {n_vocab} words, want {WIKITEXT2_VOCAB}")
        wide_argv = ["--data-dir", root, *[a for a in WIKITEXT_ARGS if a != "--synthetic"],
                     "--steps-per-epoch", str(WIKITEXT2_STEPS)]
        kept = {}
        _kept_build(trainer, kept)
        torch.cuda.reset_peak_memory_stats(device)
        try:
            wide, launches["wikitext2"] = counted(lambda: trainer.main(wide_argv), counters)
        finally:
            trainer.build = kept["build"]
        peak = torch.cuda.max_memory_allocated(device)
        if not all(math.isfinite(v) for v in wide["loss"] + wide["val_loss"]):
            raise AssertionError(f"WikiText-2 vocabulary: non-finite loss {wide['loss']}")
        gate_launches(launches["wikitext2"], wikitext_expected(wide), "WikiText-2 vocabulary")
        rows["apply_wide"] = wide_apply_phase(kept["state"].kfac_state, device)
        wide_eigh = wide_eigh_phase(kept["first_state"].kfac_state, device)
        rows["apply_wide"]["launches"] = launches["wikitext2"]["fused_precondition_stack"]
        rows["apply_wide"]["launches_per_step"] = rows["apply_wide"]["launches"] / WIKITEXT2_STEPS
        del kept
        torch.cuda.empty_cache()
        out["wikitext2"] = {
            "vocab": n_vocab, "losses": wide["loss"], "val_loss": wide["val_loss"][0],
            "refresh_step_ms": wide["step_ms"][0], "capture_step_ms": wide["step_ms"][1:],
            "peak_memory_gb": peak / 1e9, "kinds": wide["kind"], "eigh": wide_eigh,
        }
        print(f"WikiText-2 vocabulary {n_vocab}: refresh step {wide['step_ms'][0]:.1f} ms, capture "
              f"steps {wide['step_ms'][1:]}, peak memory {peak / 1e9:.2f} GB; kernel 3 at "
              f"{rows['apply_wide']['group']} within {rows['apply_wide']['max_rel_err']:.2e} of its "
              f"plain version", flush=True)

        mark("19c. tied head, GRU, RNN_TANH, resume")
        tied_argv = ["--tied", "--kfac-embedding", "--steps-per-epoch", str(WIKITEXT_TIED_STEPS)]
        tied, launches["wikitext_tied"] = counted(lambda: train_wikitext(tied_argv), counters)
        if not all(math.isfinite(v) for v in tied["loss"] + tied["val_loss"]):
            raise AssertionError(f"WikiText tied head: non-finite loss {tied['loss']}")
        gate_launches(launches["wikitext_tied"], wikitext_expected(tied, 0, embedding=True),
                      "WikiText tied head")
        tied_dense = train_wikitext([*tied_argv[:2], "--steps-per-epoch", str(ORACLE_STEPS),
                                     "--apply-kernel", "dense"])
        out["tied"] = {
            "losses": tied["loss"], "val_loss": tied["val_loss"][0],
            "oracle_max_rel_diff": gate_oracle(tied["loss"], tied_dense["loss"],
                                               "WikiText tied head", range(ORACLE_STEPS)),
            "capture_step_ms_median": step_stats(tied, args.batch_size * args.bptt)["capture_ms_median"],
        }
        rows["token_count"] = token_count_phase(ids, len(vocab))
        rows["token_count"]["launches"] = launches["wikitext_tied"]["compute_a_embed_fused"]
        rows["token_count"]["launches_per_step"] = (rows["token_count"]["launches"]
                                                   / WIKITEXT_TIED_STEPS)
        for cell in ("GRU", "RNN_TANH"):
            h, launches[f"wikitext_{cell}"] = counted(lambda: train_wikitext(
                ["--model", cell, "--steps-per-epoch", str(WIKITEXT_CELL_STEPS)]), counters)
            if not all(math.isfinite(v) for v in h["loss"] + h["val_loss"]):
                raise AssertionError(f"WikiText {cell}: non-finite loss {h['loss']}")
            gate_launches(launches[f"wikitext_{cell}"], wikitext_expected(h), f"WikiText {cell}")
            out[cell] = {"losses": h["loss"], "val_loss": h["val_loss"][0]}
        cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        whole, resumed = _resume_from_first(
            trainer.main, [*WIKITEXT_ARGS, "--steps-per-epoch", str(WIKITEXT_BOOK_STEPS)],
            tmp, "wikitext")
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
        out["resume"] = _gate_resume(
            [*zip(resumed["loss"], whole["loss"][WIKITEXT_BOOK_STEPS:]),
             (resumed["val_loss"][0], whole["val_loss"][1])], "WikiText resume")

        mark("19d. transformer LM, --tie-embeddings --kfac-embedding")
        lm_args = lm_trainer.parse_args([*LM_ARGS, *LM_TIED_EXTRA])
        lm_model = lm_trainer.build(lm_args, device)[0]
        lm_hist, launches["lm_tied"] = counted(lambda: train_lm(
            [*LM_TIED_EXTRA, "--epochs", "1", "--steps-per-epoch", str(LM_TIED_STEPS)]), counters)
        if lm_model.decoder is not None or not all(
                math.isfinite(v) for v in lm_hist["loss"] + lm_hist["val_loss"]):
            raise AssertionError(f"tied LM: losses {lm_hist['loss']} {lm_hist['val_loss']}")
        want = {"compute_a_embed_fused" if k == "token_count" else
                {"fused_apply": "fused_precondition_stack", "fused_sgd": "fused_sgd_apply",
                 "flash_forward": "flash_forward", "flash_dq": "flash_backward_dq",
                 "flash_dkv": "flash_backward_dkv"}[k]: n
                for k, n in lm_expected_launches(lm_hist, lm_model).items()}
        gate_launches(launches["lm_tied"], want, "tied LM")
        del lm_model
        oracle = lm_oracle_losses(device, ORACLE_STEPS, LM_TIED_EXTRA)
        lm_root = write_wikitext(os.path.join(tmp, "wt_lm"), 500, 40_000, 10_000, 2_000, seed=3)
        lm_data = lm_trainer.main([*[a for a in LM_ARGS if a != "--synthetic"], *LM_TIED_EXTRA,
                                   "--data-dir", lm_root, "--epochs", "1", "--steps-per-epoch", "2"])
        if not all(math.isfinite(v) for v in lm_data["loss"] + lm_data["val_loss"]):
            raise AssertionError(f"tied LM on written WikiText: {lm_data['loss']}")
        out["lm_tied"] = {
            "losses": lm_hist["loss"], "val_loss": lm_hist["val_loss"][0],
            "oracle_max_rel_diff": gate_oracle(lm_hist["loss"], oracle, "tied LM",
                                               range(ORACLE_STEPS)),
            "capture_step_ms_median": step_stats(
                lm_hist, lm_args.batch_size * lm_args.seq_len)["capture_ms_median"],
            "data_dir_losses": lm_data["loss"], "data_dir_val_loss": lm_data["val_loss"][0],
        }
    out["launches"] = launches
    return out, rows


# Phases 20a-d (slice 11): the native loader on the shard path, the
# distributed code at world 1 on NCCL and on two ranks of one card, and the
# float32 syevd watch item. The shards of phase 18 stay for 20a.
LOADER_WORKERS = 4
# two ranks on one card: ResNet-32 at batch 128 per rank, its synthetic
# batches drawn per rank (seed 100 + rank), refreshes at steps 0 and 10
TWO_RANK_ARGS = [*RESNET_ARGS, "--distribute-precondition"]
# the depth of the two-rank phases 20c-24d: 6 steps (they ran 12); where
# a gate needs a refresh after step 0 or a chunk and its swap (21e, 24d),
# the cadence refreshes every 4 steps (refresh, 3 captures, then the
# refresh or the chunk and its swap: the events 12 steps at every 10 gave)
TWO_RANK_DEPTH = 6
SHORT_CADENCE = ["--kfac-update-freq", "4"]
TWO_RANK_STEPS = TWO_RANK_DEPTH
TWO_RANK_TIMEOUT_S = 600
POOL_TIMEOUT_S = 1200  # all the pooled two-rank phases together
# the float32 syevd watch item, closed without a fault (ROADMAP queue 3;
# 16,384 to 26,733 within 3e-6 on an NVIDIA H100 80GB HBM3 at 700 W): its
# widest width, cuSOLVER's limit, stays held
SYEVD_WATCH_N = (26733,)


def loader_phase(device, counters, d256, numpy_rrc):
    """Phase 20a: the native loader (``runtime/loader.py``). Gates: the
    pass-through mode equals the numpy pipeline's batches bitwise, and
    RandomResizedCrop batches of 1 and ``LOADER_WORKERS`` threads are
    bitwise equal. Then the native transform's host milliseconds per batch
    of 32 (``native_transform``, RandomResizedCrop + flip, normalized), and
    18b's ResNet-50 on the 256x256 shards run again through the twin with
    ``--num-workers 4``, counters zeroed: images/s with the loader's
    threads overlapping the steps (the steps' and the waits' host time),
    beside 18b's numpy pipeline in series."""
    import os

    import numpy as np
    import torch

    from kfac_pytorch_tpu_torch.examples import train_imagenet_resnet as trainer
    from kfac_pytorch_tpu_torch.models import imagenet_resnet
    from kfac_pytorch_tpu_torch.runtime import loader as native
    from kfac_pytorch_tpu_torch.training import data as data_lib

    r = np.random.RandomState(5)
    xf = r.randn(512, 32, 32, 3).astype(np.float32)
    yf = r.randint(0, 10, size=512).astype(np.int32)
    got = list(native.native_epoch_batches(xf, yf, 64, shuffle=False, augment=False, seed=0,
                                           num_workers=LOADER_WORKERS))
    want = list(data_lib.epoch_batches(np.ascontiguousarray(xf.transpose(0, 3, 1, 2)), yf, 64,
                                       shuffle=False, augment=False, seed=0))
    if len(got) != len(want) or not all(np.array_equal(a, c) and np.array_equal(b, d)
                                        for (a, b), (c, d) in zip(got, want)):
        raise AssertionError("the native loader's pass-through differs from the numpy pipeline")
    x = np.load(os.path.join(d256, "train_x.npy"), mmap_mode="r")
    y = np.load(os.path.join(d256, "train_y.npy"))
    norm = dict(mean=data_lib.IMAGENET_MEAN, std=data_lib.IMAGENET_STD)

    def rrc(workers):
        loader = native.NativeEpochLoader(
            x, y, IMAGENET_BATCH, shuffle=True, mode="rrc", out_size=(224, 224),
            resize_size=256, copy=False, num_workers=workers, **norm)
        try:
            return list(loader.epoch(0))[:4]
        finally:
            loader.close()

    one, many = rrc(1), rrc(LOADER_WORKERS)
    if not all(np.array_equal(a, c) and np.array_equal(b, d) for (a, b), (c, d) in zip(one, many)):
        raise AssertionError(f"native RandomResizedCrop: 1 and {LOADER_WORKERS} threads differ")
    xb = np.ascontiguousarray(x[:IMAGENET_BATCH])
    transform_ms = []
    for i in range(10):
        t0 = time.perf_counter()
        native.native_transform(xb, (224, 224), mode="rrc", resize_size=256, seed=i,
                                num_workers=LOADER_WORKERS, **norm)
        transform_ms.append((time.perf_counter() - t0) * 1e3)

    structure = imagenet_resnet.get_model(SHARD_MODEL, generator=torch.Generator().manual_seed(0))
    hist, launches = counted(lambda: trainer.main(shard_args(
        d256, ["--steps-per-epoch", str(SHARD_STEPS), "--num-workers", str(LOADER_WORKERS)])),
        counters)
    if not all(math.isfinite(v) for v in hist["loss"] + hist["val_loss"]):
        raise AssertionError(f"native loader: non-finite loss {hist['loss']} {hist['val_loss']}")
    if len(hist["loss"]) != SHARD_STEPS or hist["val_count"] != [SHARD_VAL]:
        raise AssertionError(f"native loader: {len(hist['loss'])} steps, validation counted "
                             f"{hist['val_count']} of {SHARD_VAL} images")
    gate_launches(launches, conv_expected_launches(hist, structure, device),
                  "ImageNet shards, native loader")
    stats = step_stats(hist, IMAGENET_BATCH)
    overlapped = IMAGENET_BATCH * (SHARD_STEPS - 1) / (
        (sum(hist["step_ms"][1:]) + sum(hist["transform_ms"][1:])) / 1e3)
    out = {
        "gates": {"passthrough_equals_numpy": True, "rrc_1_and_4_threads_bitwise": True},
        "native_rrc_transform_ms_per_batch_median": statistics.median(transform_ms),
        "native_rrc_transform_ms_per_batch": transform_ms,
        "loader_wait_ms_per_batch_median": statistics.median(hist["transform_ms"][1:]),
        "capture_step_ms_median": stats["capture_ms_median"],
        "refresh_step_ms_median": stats.get("refresh_ms_median"),
        "images_per_s_steps_only": stats["per_s"],
        "images_per_s_with_loader_overlapped": overlapped,
        "numpy_pipeline_this_run": {
            "transform_ms_per_batch_median": numpy_rrc["transform_ms_per_batch_median"],
            "images_per_s_steps_only": numpy_rrc["images_per_s_steps_only"],
            "images_per_s_with_transform": numpy_rrc["images_per_s_with_transform"],
        },
        "run_q": {"images_per_s_with_transform": 82.2, "images_per_s_steps_only": 145.5},
        "val_loss": hist["val_loss"][0], "eval_ms": hist["eval_ms"][0],
        "launches": launches,
    }
    print(f"native loader ({LOADER_WORKERS} threads): {overlapped:.1f} img/s with the loader "
          f"overlapped ({stats['per_s']:.1f} over the steps alone), numpy in series this run "
          f"{numpy_rrc['images_per_s_with_transform']:.1f} (run Q: 82.2 and 145.5); native "
          f"RandomResizedCrop {statistics.median(transform_ms):.1f} ms per batch of "
          f"{IMAGENET_BATCH}", flush=True)
    return out


def in_nccl_world1(run):
    """``(run(), backend, world size)``, ``run`` inside a process group that
    ``launch.initialize`` joins on NCCL at world size 1 (``torchrun``'s
    variables set, a free ``localhost`` port), destroyed after it."""
    import os
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    os.environ.update(env)
    try:
        out = run()
        backend, world = dist.get_backend(), dist.get_world_size()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    if (backend, world) != ("nccl", 1):
        raise AssertionError(f"world-1 run on {backend} with {world} ranks, want nccl and 1")
    return out, backend, world


def world1_phase(device, counters):
    """Phase 20b: the CIFAR twin (ResNet-32, the recipe, 30 steps) through
    ``launch.initialize`` on NCCL at world size 1: its losses equal the
    non-distributed run's within ``RESUME_RTOL`` (both with deterministic
    cuDNN), and kernels 1, 3 and 4 launch as the run implies."""
    import torch

    from kfac_pytorch_tpu_torch.models import cifar_resnet

    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        plain = train([])
        (hist, launches), backend, world = in_nccl_world1(lambda: counted(lambda: train([]),
                                                                          counters))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    gate_launches(launches, conv_expected_launches(
        hist, cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0)), device),
        "ResNet-32, NCCL world 1")
    rel = [abs(a - b) / abs(b) for a, b in zip(hist["loss"], plain["loss"])]
    if len(rel) != STEPS or not max(rel) <= RESUME_RTOL:
        raise AssertionError(f"NCCL world 1: losses {hist['loss']} vs the non-distributed "
                             f"run's {plain['loss']}")
    bitwise = sum(a == b for a, b in zip(hist["loss"], plain["loss"]))
    print(f"NCCL world 1: {bitwise} of {STEPS} losses bitwise equal to the non-distributed "
          f"run's, the largest difference {max(rel):.3e} relative", flush=True)
    stats, plain_stats = step_stats(hist, BATCH), step_stats(plain, BATCH)
    return {"backend": backend, "world": world, "losses_max_rel_diff": max(rel),
            "losses_bitwise": bitwise, "steps": STEPS, "tolerance": RESUME_RTOL,
            "capture_step_ms_median": stats["capture_ms_median"],
            "plain_capture_step_ms_median": plain_stats["capture_ms_median"],
            "launches": launches}


def _two_rank_batches(device, rank, steps, batch):
    import torch

    from kfac_pytorch_tpu_torch.training.data import synthetic_batches

    return [(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
            for x, y in synthetic_batches(batch, (3, 32, 32), 10, steps, seed=100 + rank)]


def pool_worker(rank, tmp, jobs):
    """One rank of :func:`rank_pool`: each job's ``worker(rank, store,
    out_path, *args)`` in turn in this one process, with a store and an
    output path of its own, the card's cache emptied between them; the
    seconds of each job to ``tmp/pool-<rank>.json``."""
    import torch

    seconds = []
    for i, (worker, args) in enumerate(jobs):
        t0 = time.perf_counter()
        worker(rank, f"{tmp}/job{i}-store", f"{tmp}/job{i}", *args)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        seconds.append(round(time.perf_counter() - t0, 1))
    with open(f"{tmp}/pool-{rank}.json", "w") as fh:
        json.dump(seconds, fh)


def rank_pool(jobs, timeout_s):
    """The two-rank phases' ``(worker, args)`` jobs, run ahead in ONE spawn
    of two ranks (:func:`pool_worker`): each process reaches the card, and
    imports the port, once instead of once a phase. Every job's counters
    are zeroed just before its own path inside the worker, as in a spawn of
    its own. Returns each job's results in rank order, in job order (each
    phase gates its own at its place in :func:`main`), and ``{job: seconds}``
    of rank 0."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_pool_") as tmp:
        ctx = mp.spawn(pool_worker, args=(tmp, jobs), nprocs=2, join=False)
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"the pooled ranks did not finish in {timeout_s} s")
        results = []
        for i in range(len(jobs)):
            results.append([])
            for r in range(2):
                with open(f"{tmp}/job{i}-{r}.json") as fh:
                    results[-1].append(json.load(fh))
        with open(f"{tmp}/pool-0.json") as fh:
            seconds = {f"{i}:{w.__name__}": t
                       for i, ((w, _), t) in enumerate(zip(jobs, json.load(fh)))}
    return results, seconds


def spawn_ranks(worker, args, timeout_s, prefix, nprocs=2):
    """``nprocs`` ranks of ``worker(rank, store, out_path, *args)`` on the
    one card (``torch.multiprocessing`` spawn, a file store in a temporary
    directory), each writing its JSON to ``out_path-<rank>.json``: their
    results in rank order. Ranks still running after ``timeout_s`` are
    killed and fail the phase."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix=f"kfac_chip_smoke_{prefix}_") as tmp:
        ctx = mp.spawn(worker, args=(f"{tmp}/store", f"{tmp}/rank", *args), nprocs=nprocs,
                       join=False)
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"the {nprocs} ranks did not finish in {timeout_s} s")
        ranks = []
        for r in range(nprocs):
            with open(f"{tmp}/rank-{r}.json") as fh:
                ranks.append(json.load(fh))
    return ranks


def two_rank_worker(rank, store, out_path, steps, device_name, argv):
    """One rank of phases 20c and 21e (``torch.multiprocessing`` target):
    ResNet-32 with ``argv`` on ``cuda:0``, gloo over CUDA tensors, ``steps``
    steps through the refresh cadence, counted; then a refresh step and a
    capture step profiled for the collectives' host time; then, on this
    rank's state, the sharded refresh (rank-aware under a truncated solver)
    and, with ``--eigh-chunks`` > 1, a sharded chunked pass held to the
    replicated refresh through the factors they reconstruct, and the
    distributed apply held to the replicated one. Writes its results as
    JSON to ``out_path-<rank>.json``."""
    import torch

    from kfac_pytorch_tpu_torch import EigenRefreshCadence, capture
    from kfac_pytorch_tpu_torch.device import use_ieee_f32
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.models.layers import KFACConv
    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
    from kfac_pytorch_tpu_torch.ops import precondition as pc
    from kfac_pytorch_tpu_torch.parallel import launch
    from kfac_pytorch_tpu_torch.parallel.assignment import (
        layer_assignment,
        plan_eigh_chunks,
        precondition_assignment,
    )
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world
    from kfac_pytorch_tpu_torch.parallel.sharded_eigh import (
        build_slots,
        replicated_eigen_update,
        sharded_eigen_chunk_update,
        sharded_eigen_update,
    )
    from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step, step_kind

    device = launch.initialize(device_name, backend="gloo", init_method=f"file://{store}",
                               rank=rank, world_size=2)
    try:
        use_ieee_f32()
        world = data_parallel_world()
        args = trainer.parse_args(argv)
        model, kfac, state, step_fn = trainer.build(args, device, world)
        batches = _two_rank_batches(device, rank, steps, args.batch_size)
        lr = args.base_lr * world.size
        cadence = EigenRefreshCadence(kfac)
        counters = (fk.compute_a_conv_fused, ak.fused_precondition_stack, ak.fused_sgd_apply)
        zero_counts(counters)
        losses, kinds = [], []
        for i, batch in enumerate(batches):
            flags = cadence.flags_for_step(i, 0)
            state, m = step_fn(state, batch, lr, kfac.hparams.damping, **flags)
            losses.append(float(m["loss"]))
            kinds.append(step_kind(flags))
        launches = read_counts(counters)
        # the collectives' host time on a refresh step and a capture step
        exchange = {}
        for label, i in (("refresh", 10 * steps), ("capture", 10 * steps + 1)):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                state, m = step_fn(state, batches[0], lr, kfac.hparams.damping,
                                   **kfac_flags_for_step(i, kfac, 0))
                float(m["loss"])
            ops = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
                   if e.key.startswith("gloo:")}
            if not ops:
                ops = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
                       if e.key.startswith("c10d::")}
            exchange[label] = {"ms": sum(ops.values()), "ops": ops}
        # the sharded refreshes against the replicated one, through the
        # factors they reconstruct; the distributed apply (kernel 3 on the
        # owned groups of dense entries) against the replicated apply
        facs = state.kfac_state["factors"]
        names, rank_fn = list(facs), kfac._rank_fn()
        table = layer_assignment(names, {n: True for n in names}, world.size,
                                 kfac.distribute_layer_factors, 1)
        replicated = replicated_eigen_update(facs, {n: 1 for n in names}, rank_fn=rank_fn)
        refresh_rel = max_recon_diff(sharded_eigen_update(facs, table, world, rank_fn=rank_fn),
                                     replicated)
        chunked_rel = None
        if kfac.eigh_chunks > 1:
            slots = build_slots(facs, table)
            plan = plan_eigh_chunks(slots, kfac.eigh_chunks, rank_fn=rank_fn)
            pending = {n: {k: torch.zeros_like(v) for k, v in e.items()}
                       for n, e in replicated.items()}
            for c in range(kfac.eigh_chunks):
                pending = sharded_eigen_chunk_update(facs, pending, [slots[i] for i in plan[c]],
                                                     world, rank_fn=rank_fn)
            chunked_rel = max_recon_diff(pending, replicated)
        grads = {n: p.grad for n, p in model.named_parameters()}
        gmats = {n: g.float() for n, g in capture.grad_mats(
            capture.layer_grads(grads, names, set())).items()}
        eigen, stacked = state.kfac_state["eigen"], state.kfac_state["eigen_stacked"]
        owners = precondition_assignment({n: tuple(g.shape) for n, g in gmats.items()},
                                         world.size)
        got = pc.precondition_all_distributed(gmats, eigen, kfac.hparams.damping, stacked,
                                              world=world, owners=owners, kind="auto")
        want, _ = pc.precondition_all_with_vg(gmats, eigen, kfac.hparams.damping, stacked,
                                              kind="auto")
        apply_rel = max(float((got[n] - want[n]).abs().max() / want[n].abs().max())
                        for n in names)
        full = full_eigen(state.kfac_state)
        groups = pc.shape_groups({n: tuple(g.shape) for n, g in gmats.items()})
        dense = [g for g in groups.values() if not pc.entry_is_lowrank(full[g[0]])]
        owned = sum(any(owners[n] == rank for n in g) for g in dense)
        applied = owned if kfac.distribute_precondition else len(dense)
        result = {
            "rank": rank, "device": str(device), "backend": torch.distributed.get_backend(),
            "losses": losses, "kinds": kinds, "launches": launches,
            "expected_launches": {
                "compute_a_conv_fused": steps * sum(isinstance(m, KFACConv)
                                                    for m in model.modules()),
                "fused_precondition_stack": applied * steps,
                "fused_sgd_apply": steps,
            },
            "exchange_ms": exchange,
            "refresh_recon_max_rel_diff": refresh_rel,
            "chunked_refresh_recon_max_rel_diff": chunked_rel,
            "apply_max_rel_diff": apply_rel,
            "truncated_sides": sum(k.startswith("rho") for e in full.values() for k in e),
            "owned_shape_groups": owned, "dense_shape_groups": len(dense),
            "shape_groups": len(groups),
        }
        with open(f"{out_path}-{rank}.json", "w") as fh:
            json.dump(result, fh)
    finally:
        torch.distributed.destroy_process_group()


def two_rank_phase(device, ranks, argv=TWO_RANK_ARGS):
    """Phases 20c and 21e: ``ranks``, :func:`two_rank_worker`'s two ranks
    on the one card (gloo over CUDA tensors: NCCL refuses two ranks on one
    device), ResNet-32 with ``argv`` (20c: ``--distribute-precondition``;
    21e: ``--eigh-chunks 2 --solver rsvd --solver-auto-threshold 256``):
    kernels 1, 3 (on each rank's owned groups of dense entries, or all of
    them without ``--distribute-precondition``) and 4 launch in each rank as
    the run implies; the sharded refresh (and chunked pass) within
    ``EIGH_TOL`` and the distributed apply's updates within 1e-6 of the
    replicated ones (of the largest entry); the first 5 losses within 1e-3
    of one process running the ranks' batches concatenated; the
    collectives' host milliseconds per refresh step and per capture step
    from ``torch.profiler``."""
    import torch

    from kfac_pytorch_tpu_torch import EigenRefreshCadence
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    for res in ranks:
        for name, n in res["expected_launches"].items():
            if res["launches"][name] != n or n <= 0:
                raise AssertionError(f"rank {res['rank']}: {name} launched "
                                     f"{res['launches'][name]} times, the run implies {n}")
        for key in ("refresh_recon_max_rel_diff", "chunked_refresh_recon_max_rel_diff"):
            if res[key] is not None and not res[key] <= EIGH_TOL:
                raise AssertionError(f"rank {res['rank']}: {key} {res[key]:.2e} from the "
                                     f"replicated refresh (tolerance {EIGH_TOL})")
        if not res["apply_max_rel_diff"] <= 1e-6:
            raise AssertionError(f"rank {res['rank']}: distributed apply {res['apply_max_rel_diff']:.2e} "
                                 "from the replicated one (tolerance 1e-6)")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError("the ranks' losses (means over the ranks) differ")
    # one process on the concatenated global batch
    args = trainer.parse_args([a for a in argv if a != "--distribute-precondition"])
    parts = [_two_rank_batches(device, r, ORACLE_STEPS, args.batch_size) for r in range(2)]
    args.batch_size *= 2
    _, kfac, state, step_fn = trainer.build(args, device)
    cadence, one = EigenRefreshCadence(kfac), []
    for i in range(ORACLE_STEPS):
        batch = tuple(torch.cat([parts[0][i][j], parts[1][i][j]]) for j in range(2))
        state, m = step_fn(state, batch, args.base_lr * 2, kfac.hparams.damping,
                           **cadence.flags_for_step(i, 0))
        one.append(float(m["loss"]))
    del state, step_fn, kfac
    if device.type == "cuda":
        torch.cuda.empty_cache()
    worst = gate_oracle(ranks[0]["losses"], one, "two ranks vs one process", range(ORACLE_STEPS))
    chunked = ranks[0]["chunked_refresh_recon_max_rel_diff"]
    print(f"two ranks on one card ({' '.join(argv[len(RESNET_ARGS):])}; gloo over CUDA "
          f"tensors): kernels 1, 3 and 4 launched in each rank as implied; the sharded refresh "
          f"{ranks[0]['refresh_recon_max_rel_diff']:.2e}"
          + (f" and a chunked pass {chunked:.2e}" if chunked is not None else "")
          + f" from the replicated one; the first {ORACLE_STEPS} losses within {worst:.2e} of "
          f"one process on the concatenated batch; collectives "
          f"{ranks[0]['exchange_ms']['refresh']['ms']:.1f} ms per refresh step, "
          f"{ranks[0]['exchange_ms']['capture']['ms']:.1f} ms per capture step (rank 0's host "
          "time)", flush=True)
    return {"ranks": ranks, "one_process_losses": one, "max_rel_diff_vs_one_process": worst,
            "steps": TWO_RANK_STEPS, "argv": list(argv)}


def ema_like_factor(n, device, seed):
    """A K-FAC factor as an EMA leaves it: 0.95³⁰ of the identity (the
    decayed start) plus the covariance of 2,048 random rows, so ``n −
    2048`` eigenvalues sit in one cluster."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(2048, n, generator=g, device=device)
    f = x.T @ x / 2048
    del x
    f.diagonal().add_(0.95 ** 30)
    return f


def syevd_watch_phase(device, widths=SYEVD_WATCH_N):
    """Phase 20d (the float32 syevd watch item, closed): the port's route
    (``ops/eigh.py::eigh_with_floor``, float32 ``syevd`` up to its limit)
    of an EMA-like factor at each of ``widths``, held in float64 on 256
    random directions (``decomposition_errors``) within ``EIGH_TOL``
    (phase 19b's bound)."""
    import torch

    from kfac_pytorch_tpu_torch.ops import eigh as eigh_ops

    out = []
    for n in widths:
        f = ema_like_factor(n, device, n)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        q, d = eigh_ops.eigh_with_floor(f)
        torch.cuda.synchronize(device)
        port_s = time.perf_counter() - t0
        port = decomposition_errors(f, q, d, device)
        del d, q, f
        torch.cuda.empty_cache()
        route = "float32 syevd" if n <= eigh_ops.SYEVD_MAX_N else "spectral split"
        out.append({"n": n, "port_route": route, "reconstruction_rel": port[0],
                    "orthogonality": port[1], "s": port_s, "tolerance": EIGH_TOL})
        print(f"eigh at n = {n}, the port's {route}: reconstruction {port[0]:.2e}, "
              f"orthogonality {port[1]:.2e} ({port_s:.1f} s)", flush=True)
        if not (port[0] <= EIGH_TOL and port[1] <= EIGH_TOL):
            raise AssertionError(f"eigh of an EMA-like {n}-wide factor on the port's route "
                                 f"({route}): reconstruction {port[0]:.2e}, "
                                 f"orthogonality {port[1]:.2e} (tolerance {EIGH_TOL})")
    return out


# Phases 21a-e (slice 12): the pipelined refresh and the truncated solvers
# through the twins. ResNet-32 with --eigh-chunks (21a: phase 4's recipe,
# kfac-update-freq 10, 5 chunks); the LM (21b) and WikiText-2's vocabulary
# (21c) with --solver rsvd at the JAX trainers' defaults (rank 128, sides
# from 512 truncated); the WikiText LSTM with --solver streaming (21d); two
# ranks on the one card with --eigh-chunks 2 --solver rsvd (21e).
REFRESH_CHUNKS = 5
SOLVER_RSVD = ["--solver", "rsvd"]
# 21e: ResNet-32's 288- and 576-wide A sides truncated, the rest dense
TWO_RANK_SOLVER_ARGS = [*RESNET_ARGS, "--eigh-chunks", "2", "--solver", "rsvd",
                        "--solver-auto-threshold", "256", *SHORT_CADENCE]
# 21d: the degenerate streaming schedule held to periodic rsvd
STREAM_EXACT_STEPS = 5
# 21c: steps at WikiText-2's vocabulary, refreshes at 0 (the first call's
# set-up included, as 19b's) and 10 (warm)
WIKITEXT2_RSVD_STEPS = 11


def kind_medians(hist):
    """Median step ms by step kind, step 0 left out (first-call set-up)."""
    by = {}
    for ms, kind in zip(hist["step_ms"][1:], hist["kind"][1:]):
        by.setdefault(kind, []).append(ms)
    return {k: statistics.median(v) for k, v in by.items()}


def apply_groups(kfac_state):
    """The shape groups kernel 3 takes in a K-FAC state: the stacks and the
    single layers with a full eigenbasis on both sides (a truncated side
    takes its Woodbury solve, an embedding its diagonal one)."""
    from kfac_pytorch_tpu_torch.ops.precondition import entry_is_lowrank

    singles = sum("QA" in e and not entry_is_lowrank(e) for e in kfac_state["eigen"].values())
    return singles + sum(not entry_is_lowrank(e) for e in kfac_state["eigen_stacked"].values())


def full_eigen(kfac_state):
    """Per-layer eigen entries of a state: its singles, and its stacks'
    rows (a stack's rows are its shape's layers in the factors' order)."""
    out = {n: dict(e) for n, e in kfac_state["eigen"].items()}
    facs = kfac_state["factors"]
    for key, group in kfac_state["eigen_stacked"].items():
        rows = [n for n in facs if n not in out and "A" in facs[n]
                and f"{facs[n]['G'].shape[0]}x{facs[n]['A'].shape[0]}" == key]
        for row, n in enumerate(rows):
            out[n] = {k: v[row] for k, v in group.items()}
    return out


def max_recon_diff(got, want):
    """The largest difference of the factors two eigen dicts reconstruct,
    ``Q diag(d) Qᵀ`` plus ``rho (I − Q Qᵀ)`` for a truncated side, over the
    largest entry, per side, in float64."""
    import torch

    def recon(e, side):
        q = e[f"Q{side}"].double()
        f = (q * e[f"d{side}"].double()) @ q.T
        if f"rho{side}" in e:
            f += float(e[f"rho{side}"]) * (torch.eye(q.shape[0], dtype=f.dtype, device=f.device)
                                           - q @ q.T)
        return f

    worst = 0.0
    for n, e in want.items():
        for side in ("A", "G"):
            if f"Q{side}" in e:
                w = recon(e, side)
                worst = max(worst, float((recon(got[n], side) - w).abs().max() / w.abs().max()))
    return worst


def chunks_phase(device, counters, eigen_stats):
    """Phase 21a: ResNet-32 through the CIFAR twin with the pipelined
    refresh. ``--eigh-chunks 1`` gives 30 losses bitwise equal to the run
    without the flag (deterministic cuDNN, both in this call); ``--eigh-chunks
    5`` for 30 steps: a monolithic bootstrap, then chunk steps with the swap
    on the 5th, the loss finite and falling, kernels 1, 3 and 4 as implied;
    on the run's last factors, frozen, a full chunked pass's swapped basis
    reconstructs the factors of a monolithic refresh within ``EIGH_TOL``.
    The chunk step's median ms beside the capture step's and phase 4's
    refresh step's."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.parallel.sharded_eigh import replicated_eigen_update

    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        plain = train([])
        one = train(["--eigh-chunks", "1"])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    if one["loss"] != plain["loss"] or one["kind"] != plain["kind"]:
        raise AssertionError(f"--eigh-chunks 1: losses {one['loss']} differ from the plain "
                             f"run's {plain['loss']}")
    kept = {}
    _kept_build(trainer, kept)
    try:
        hist, launches = counted(lambda: train(["--eigh-chunks", str(REFRESH_CHUNKS)]), counters)
    finally:
        trainer.build = kept["build"]
    interval = ["chunk"] * (REFRESH_CHUNKS - 1) + ["chunk-swap"] + ["capture"] * (10 - REFRESH_CHUNKS)
    want = ["refresh"] + ["capture"] * 9 + interval * ((STEPS - 10) // 10)
    if hist["kind"] != want:
        raise AssertionError(f"--eigh-chunks {REFRESH_CHUNKS}: step kinds {hist['kind']}, want {want}")
    first, last = gate_falling(hist["loss"], f"ResNet-32 --eigh-chunks {REFRESH_CHUNKS}")
    gate_launches(launches, cifar_expected_launches(hist, device),
                  f"ResNet-32 --eigh-chunks {REFRESH_CHUNKS}")
    # the swapped basis of frozen factors against a monolithic refresh
    kfac, model = kept["kfac"], kept["model"]
    ks = kept["state"].kfac_state
    grads = {n: p.grad for n, p in model.named_parameters()}
    for c in range(REFRESH_CHUNKS):
        _, ks = kfac.update(grads, ks, lr=0.1, update_factors=False, update_eigen=False,
                            eigen_chunk=(c, REFRESH_CHUNKS), swap_eigen=c == REFRESH_CHUNKS - 1)
    mono = replicated_eigen_update(ks["factors"], {n: 1 for n in ks["factors"]})
    swap_rel = max_recon_diff(full_eigen(ks), mono)
    if not swap_rel <= EIGH_TOL:
        raise AssertionError(f"the chunked refresh's swapped basis {swap_rel:.2e} from a "
                             f"monolithic refresh of the same factors (tolerance {EIGH_TOL})")
    med = kind_medians(hist)
    del kept, ks, grads
    print(f"--eigh-chunks {REFRESH_CHUNKS}: chunk step {med['chunk']:.2f} ms (median; with the "
          f"swap {med['chunk-swap']:.2f}) against capture {med['capture']:.2f} and phase 4's "
          f"refresh {eigen_stats['refresh_ms_median']:.2f}; the swapped basis within "
          f"{swap_rel:.2e} of a monolithic refresh; --eigh-chunks 1 bitwise", flush=True)
    return {"chunks": REFRESH_CHUNKS, "steps": STEPS, "kinds": hist["kind"],
            "loss_first5": first, "loss_last5": last, "one_chunk_losses_bitwise": True,
            "chunk_step_ms_median": med["chunk"], "swap_step_ms_median": med["chunk-swap"],
            "capture_step_ms_median": med["capture"],
            "phase4_refresh_step_ms_median": eigen_stats["refresh_ms_median"],
            "phase4_capture_step_ms_median": eigen_stats["capture_ms_median"],
            "swap_vs_monolithic_recon_max_rel_diff": swap_rel, "tolerance": EIGH_TOL,
            "launches": launches}


def lm_rsvd_phase(device, counters, eigh_stats):
    """Phase 21b: the LM twin at the LM path's widths with ``--solver rsvd``
    (38 steps): the loss finite and falling, kernels 2 and 4-7 as implied
    and kernel 3 on the groups without a truncated side only; the first 5
    losses within 1e-3 of the same flags with ``--apply-kernel dense``; the
    refresh step's median ms beside phase 8's (eigh) and the spectrum mass
    the truncated bases captured; then one refresh step of each solver
    (step 10) profiled: device time by kernel group and the idle share."""
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    args = trainer.parse_args([*LM_ARGS, *SOLVER_RSVD])
    model, _, state = trainer.build(args, device)[:3]
    groups = apply_groups(state.kfac_state)
    truncated = sum(k.startswith("rho") for e in full_eigen(state.kfac_state).values() for k in e)
    del state
    hist, launches = counted(lambda: train_lm(["--epochs", str(LM_EPOCHS), *SOLVER_RSVD]), counters)
    first, last = gate_falling(hist["loss"], "LM --solver rsvd")
    names = {"token_count": "compute_a_embed_fused", "fused_apply": "fused_precondition_stack",
             "fused_sgd": "fused_sgd_apply", "flash_forward": "flash_forward",
             "flash_dq": "flash_backward_dq", "flash_dkv": "flash_backward_dkv"}
    want = {names[k]: n for k, n in lm_expected_launches(hist, model).items()}
    want["fused_precondition_stack"] = groups * len(hist["loss"])
    gate_launches(launches, want, "LM --solver rsvd")
    del model
    dense = train_lm(["--epochs", "1", "--steps-per-epoch", str(ORACLE_STEPS), *SOLVER_RSVD,
                      "--apply-kernel", "dense"])
    worst = gate_oracle(hist["loss"], dense["loss"], "LM --solver rsvd", range(ORACLE_STEPS))
    med = kind_medians(hist)
    mass = hist["kfac_spectrum_mass"][-1]
    profile = profile_path(lm_setup, device, [((), [("eigh_refresh", 10, 11)]),
                                              (tuple(SOLVER_RSVD), [("rsvd_refresh", 10, 11)])])
    for label, p in profile.items():
        print(f"LM {label} step profiled: wall {p['wall_ms_per_step']:.1f} ms, device busy "
              f"{p['device_busy_ms_per_step']:.1f} (idle {p['device_idle_share']:.0%}); by group "
              f"{json.dumps({g: round(v, 2) for g, v in p['by_group_ms_per_step'].items()})}",
              flush=True)
    print(f"LM --solver rsvd: refresh step {med['refresh']:.2f} ms (median) against phase 8's "
          f"eigh {eigh_stats['refresh_ms_median']:.2f}; capture {med['capture']:.2f}; "
          f"spectrum mass {mass:.4f}; {truncated} truncated sides, kernel 3 on {groups} "
          f"groups", flush=True)
    return {"steps": len(hist["loss"]), "loss_first5": first, "loss_last5": last,
            "refresh_step_ms_median": med["refresh"], "capture_step_ms_median": med["capture"],
            "phase8_refresh_step_ms_median": eigh_stats["refresh_ms_median"],
            "phase8_capture_step_ms_median": eigh_stats["capture_ms_median"],
            "spectrum_mass": hist["kfac_spectrum_mass"], "truncated_sides": truncated,
            "apply_kernel_groups": groups, "dense_apply_max_rel_diff": worst,
            "refresh_profiles": profile, "launches": launches, "expected_launches": want}


def wide_rsvd_phase(device, counters, wide_eigh):
    """Phase 21c: WikiText-2's vocabulary (19b's corpus, written again)
    with ``--solver rsvd`` for ``WIKITEXT2_RSVD_STEPS`` steps: the refresh
    steps' ms (step 0 as 19b's, and step 10 warm) and the peak memory
    beside 19b's eigh (same call); the truncated G basis of the
    33,278-wide factor orthonormal within ``EIGH_TOL`` in float64 on 256
    random directions, its Rayleigh quotients ``Qᵀ G Q`` against ``d``
    reported; the spectrum mass; the capture step's ms; counters as
    implied (kernel 3 on no group: both decoder sides truncated)."""
    import os
    import tempfile

    import torch

    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer

    with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_wt2_rsvd_") as tmp:
        root = write_wikitext(os.path.join(tmp, "wt2"), WIKITEXT2_VOCAB, 60_000, 8_000, 2_000)
        argv = ["--data-dir", root, *[a for a in WIKITEXT_ARGS if a != "--synthetic"],
                "--steps-per-epoch", str(WIKITEXT2_RSVD_STEPS), *SOLVER_RSVD]
        kept = {}
        _kept_build(trainer, kept)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        try:
            wide, launches = counted(lambda: trainer.main(argv), counters)
        finally:
            trainer.build = kept["build"]
        peak = torch.cuda.max_memory_allocated(device)
    if not all(math.isfinite(v) for v in wide["loss"] + wide["val_loss"]):
        raise AssertionError(f"WikiText-2 vocabulary, --solver rsvd: losses {wide['loss']}")
    gate_launches(launches, wikitext_expected(wide, apply_groups(kept["state"].kfac_state)),
                  "WikiText-2 vocabulary --solver rsvd")
    first = kept["first_state"].kfac_state
    e, g = first["eigen"]["decoder"], first["factors"]["decoder"]["G"]
    if e["QG"].shape != (WIKITEXT2_VOCAB, 128) or "rhoG" not in e:
        raise AssertionError(f"the decoder's G side was not truncated: QG {tuple(e['QG'].shape)}")
    _, orth = decomposition_errors(g, e["QG"], e["dG"], device)
    if not orth <= EIGH_TOL:
        raise AssertionError(f"the truncated G basis of the {WIKITEXT2_VOCAB}-wide factor: "
                             f"orthogonality {orth:.2e} (tolerance {EIGH_TOL})")
    gq = torch.cat([g[lo:lo + 4096].double() @ e["QG"].double()
                    for lo in range(0, g.shape[0], 4096)])
    ritz = float((e["QG"].double().T @ gq - torch.diag(e["dG"].double())).abs().max()
                 / e["dG"].double().abs().max())
    del kept, first, e, g, gq
    torch.cuda.empty_cache()
    mass = wide["kfac_spectrum_mass"][-1]
    capture = statistics.median(wide["step_ms"][1:10])
    print(f"WikiText-2 vocabulary --solver rsvd: refresh steps {wide['step_ms'][0]:.1f} ms (step "
          f"0; 19b's eigh: {wide_eigh['refresh_step_ms']:.1f}) and {wide['step_ms'][10]:.1f} "
          f"(step 10), capture step {capture:.1f} (median), "
          f"peak {peak / 1e9:.2f} GB (19b: {wide_eigh['peak_memory_gb']:.2f}); G basis "
          f"orthogonality {orth:.2e}, Rayleigh quotients within {ritz:.2e} of d; spectrum "
          f"mass {mass:.4f}", flush=True)
    return {"vocab": WIKITEXT2_VOCAB, "losses": wide["loss"], "val_loss": wide["val_loss"][0],
            "refresh_step_ms": wide["step_ms"][0], "warm_refresh_step_ms": wide["step_ms"][10],
            "capture_step_ms_median": capture, "step_ms": wide["step_ms"],
            "peak_memory_gb": peak / 1e9, "eigh_refresh_step_ms": wide_eigh["refresh_step_ms"],
            "eigh_capture_step_ms": wide_eigh["capture_step_ms"],
            "eigh_peak_memory_gb": wide_eigh["peak_memory_gb"],
            "g_basis_orthogonality": orth, "g_ritz_max_rel_diff": ritz, "tolerance": EIGH_TOL,
            "directions": 256, "spectrum_mass": mass, "kinds": wide["kind"], "launches": launches}


def streaming_phase(device, counters, lstm):
    """Phase 21d: the WikiText LSTM (19a's recipe) with ``--solver
    streaming`` for 30 steps: at most ``ceil(30/10)`` re-orthonormalizations,
    the loss finite and falling, counters as implied; the fold (capture)
    step's median ms beside 19a's capture step's; the residual gauge at
    each boundary. Then ``STREAM_EXACT_STEPS`` steps with
    ``--stream-drift-threshold 0 --kfac-update-freq 1`` against ``--solver
    rsvd`` (deterministic cuDNN): bitwise equal when two rsvd runs are."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer

    args = trainer.parse_args([*WIKITEXT_ARGS, "--solver", "streaming"])
    _, vocab = trainer.load_corpus(args)
    groups = apply_groups(trainer.build(args, len(vocab), device)[2].kfac_state)
    hist, launches = counted(lambda: train_wikitext(
        ["--steps-per-epoch", str(WIKITEXT_STEPS), "--solver", "streaming"]), counters)
    first, last = gate_falling(hist["loss"], "WikiText LSTM --solver streaming")
    gate_launches(launches, wikitext_expected(hist, groups), "WikiText LSTM --solver streaming")
    reorth = hist["kind"].count("refresh")
    bound = math.ceil(WIKITEXT_STEPS / 10)
    if not 1 <= reorth <= bound:
        raise AssertionError(f"streaming: {reorth} re-orthonormalizations in {WIKITEXT_STEPS} "
                             f"steps, at most {bound}")
    residual = hist["kfac_stream_residual"]
    boundaries = [s for s in range(0, WIKITEXT_STEPS, 10)]
    at_boundary = [{"step": s, "read": residual[s - 1] if s else None, "after": residual[s],
                    "reorth": hist["kind"][s] == "refresh"} for s in boundaries]
    med = kind_medians(hist)
    exact = ["--steps-per-epoch", str(STREAM_EXACT_STEPS), "--kfac-update-freq", "1"]
    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        strm = train_wikitext([*exact, "--solver", "streaming", "--stream-drift-threshold", "0"])
        rsvd = train_wikitext([*exact, *SOLVER_RSVD])
        rsvd_again = train_wikitext([*exact, *SOLVER_RSVD])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    if strm["kind"] != ["refresh"] * STREAM_EXACT_STEPS:
        raise AssertionError(f"streaming at threshold 0: step kinds {strm['kind']}")
    repeatable = rsvd["loss"] == rsvd_again["loss"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(strm["loss"], rsvd["loss"]))
    if repeatable and strm["loss"] != rsvd["loss"]:
        raise AssertionError(f"streaming at threshold 0 {strm['loss']} not bitwise --solver "
                             f"rsvd's {rsvd['loss']}, which repeats bitwise")
    if not repeatable and not rel <= RESUME_RTOL:
        raise AssertionError(f"streaming at threshold 0: {rel:.2e} from --solver rsvd")
    print(f"LSTM --solver streaming: {reorth} re-orthonormalizations in {WIKITEXT_STEPS} steps, "
          f"fold step {med['capture']:.2f} ms (median) against 19a's capture step "
          f"{lstm['capture_step_ms_median']:.2f}; residual read at the boundaries "
          f"{[b['read'] for b in at_boundary]}; threshold 0 at freq 1 "
          f"{'bitwise' if rel == 0 else f'{rel:.2e} from'} --solver rsvd", flush=True)
    return {"steps": WIKITEXT_STEPS, "loss_first5": first, "loss_last5": last,
            "reorth": reorth, "reorth_bound": bound, "kinds": hist["kind"],
            "fold_step_ms_median": med["capture"], "reorth_step_ms_median": med.get("refresh"),
            "phase19a_capture_step_ms_median": lstm["capture_step_ms_median"],
            "phase19a_refresh_step_ms_median": lstm["refresh_step_ms_median"],
            "residual_at_boundaries": at_boundary, "residual": residual,
            "exact_steps": STREAM_EXACT_STEPS, "rsvd_repeats_bitwise": repeatable,
            "streaming_vs_rsvd_max_rel_diff": rel, "launches": launches}


# Phase 22 (slice 13): the factor comm plane and the LM twins across ranks.
COMM_LM_FLAGS = ["--factor-comm-dtype", "bf16", "--factor-comm-freq", "2",
                 "--grad-comm-dtype", "bf16"]
COMM_STEPS = TWO_RANK_DEPTH
# the bf16 factor and gradient wires against the float32 wire, every loss
# (~10x the 4.13e-6 measured on an H100)
COMM_BF16_RTOL = 5e-5
# the int8 factor wire against the float32 wire, every loss (~10x the
# 4.86e-6 measured on an H100)
COMM_INT8_RTOL = 5e-5
# one quantization step per element: ‖residual‖ ≤ (√256 / 127)·‖payload‖
RESIDUAL_BOUND = 16 / 127
COMM_RUNS = (  # (name, twin, argv)
    ("lm_f32", "lm", [*LM_ARGS, "--factor-comm-freq", "2"]),
    ("lm_bf16", "lm", [*LM_ARGS, *COMM_LM_FLAGS]),
    ("lstm_f32", "lstm", [*WIKITEXT_ARGS, "--factor-comm-freq", "4"]),
    ("lstm_int8", "lstm", [*WIKITEXT_ARGS, "--factor-comm-dtype", "int8",
                           "--factor-comm-freq", "4"]),
    ("cifar_bf16", "cifar", [*RESNET_ARGS, *COMM_LM_FLAGS]),
)
LM_COUNTERS = {"token_count": "compute_a_embed_fused", "fused_apply": "fused_precondition_stack",
               "fused_sgd": "fused_sgd_apply", "flash_forward": "flash_forward",
               "flash_dq": "flash_backward_dq", "flash_dkv": "flash_backward_dkv"}


def lm_world1_phase(device, counters, lm_hist, lm_capture_ms, world1):
    """Phase 22a: the LM twin with the comm plane's levers on NCCL at world
    size 1, phase 8's 38 steps: losses within ``RESUME_RTOL`` of phase 8's,
    kernels 2 and 3-7 as implied, the capture step's median beside phase
    8's and 20b's."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    (hist, launches), backend, world = in_nccl_world1(
        lambda: counted(lambda: train_lm(["--epochs", str(LM_EPOCHS), *COMM_LM_FLAGS]), counters))
    args = trainer.parse_args(LM_ARGS)
    model = trainer.build(args, device)[0]
    expected = {LM_COUNTERS[k]: n for k, n in lm_expected_launches(hist, model).items()}
    del model
    torch.cuda.empty_cache()
    gate_launches(launches, expected, "LM, NCCL world 1")
    rel = [abs(a - b) / abs(b) for a, b in zip(hist["loss"], lm_hist["loss"])]
    if len(rel) != len(lm_hist["loss"]) or not max(rel) <= RESUME_RTOL:
        raise AssertionError(f"LM at NCCL world 1: losses {hist['loss']} vs phase 8's "
                             f"{lm_hist['loss']}")
    bitwise = sum(a == b for a, b in zip(hist["loss"], lm_hist["loss"]))
    stats = step_stats(hist, args.batch_size * args.seq_len)
    print(f"LM at NCCL world 1 ({' '.join(COMM_LM_FLAGS)}): {bitwise} of {len(rel)} losses "
          f"bitwise phase 8's; capture step {stats['capture_ms_median']:.2f} ms (phase 8 "
          f"{lm_capture_ms:.2f}; ResNet-32 at world 1 {world1['capture_step_ms_median']:.2f}, "
          f"without a group {world1['plain_capture_step_ms_median']:.2f})", flush=True)
    return {"backend": backend, "world": world, "flags": COMM_LM_FLAGS,
            "losses_max_rel_diff": max(rel), "losses_bitwise": bitwise, "steps": len(rel),
            "capture_step_ms_median": stats["capture_ms_median"],
            "refresh_step_ms_median": stats["refresh_ms_median"],
            "phase8_capture_step_ms_median": lm_capture_ms,
            "resnet32_world1_capture_step_ms_median": world1["capture_step_ms_median"],
            "resnet32_plain_capture_step_ms_median": world1["plain_capture_step_ms_median"],
            "launches": launches, "expected_launches": expected}


def tensor_digest(tensors):
    """The SHA-256 of the tensors' bytes, in order: equal digests mean
    bitwise-equal tensors."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _comm_run(twin, argv, device, world, steps, keep=None):
    """One of ``COMM_RUNS`` on this rank: ``steps`` counted steps through the
    refresh cadence on this rank's rows, then a flush step (deferred runs)
    and a capture step profiled for the collectives' host ms; after each
    flush the digests of the factors and the parameters, and on the int8
    wire the residual's and the factors' norms. The CIFAR twin runs through
    its ``main()``: ``steps`` counted steps. ``keep`` (a dict) receives the
    LM twins' model, preconditioner and final state."""
    import torch

    from kfac_pytorch_tpu_torch import EigenRefreshCadence
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as cifar_trainer
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm_trainer
    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as wt_trainer
    from kfac_pytorch_tpu_torch.models import cifar_resnet
    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
    from kfac_pytorch_tpu_torch.ops import flash_attention as fa
    from kfac_pytorch_tpu_torch.parallel.comm import publish_wire_quant_error
    from kfac_pytorch_tpu_torch.parallel.mesh import local_rows
    from kfac_pytorch_tpu_torch.training import data as data_lib
    from kfac_pytorch_tpu_torch.training.lm_step import init_carry
    from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step, step_kind

    counters = (fk.compute_a_conv_fused, fk.compute_a_conv_grouped_fused,
                fk.compute_a_embed_fused, ak.fused_precondition_stack, ak.fused_sgd_apply,
                fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    if twin == "cifar":
        hist, launches = counted(
            lambda: cifar_trainer.main([*argv, "--steps-per-epoch", str(steps)]), counters)
        model = cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0))
        return {"losses": hist["loss"], "kinds": hist["kind"], "step_ms": hist["step_ms"],
                "launches": launches,
                "expected_launches": conv_expected_launches(hist, model, device)}
    if twin == "lm":
        args = lm_trainer.parse_args(argv)
        model, kfac, state, step_fn, splits = lm_trainer.build(args, device, world=world)
        stream = lm_trainer.rank_rows(splits["train"], args, world)
        seg, lr = args.seq_len, args.base_lr
    else:
        args = wt_trainer.parse_args(argv)
        splits, vocab = wt_trainer.load_corpus(args)
        model, kfac, state, lm_step = wt_trainer.build(args, len(vocab), device, world)
        stream = data_lib.batchify_tokens(splits["train"], args.batch_size)[
            local_rows(args.batch_size, world)]
        seg, lr = args.bptt, args.base_lr
        carry = [init_carry(model, stream.shape[0], device)]
        gen = torch.Generator(device=device).manual_seed(args.seed)

        def step_fn(state, batch, lr, damping, **flags):
            state, carry[0], m = lm_step(state, batch, carry[0], gen, lr, damping, **flags)
            return state, m
    # the LM's synthetic stream holds 9 segments at a global batch of 8: the
    # steps after them take its segments again, as a second epoch would
    batches = [lm_trainer.device_batch(x, y, device)
               for x, y in data_lib.bptt_batches(stream, seg)][:steps]
    cadence = EigenRefreshCadence(kfac)
    out = {"losses": [], "kinds": [], "step_ms": [], "flush_residual": [],
           "flush_digests": [], "segments": len(batches)}
    zero_counts(counters)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda _: None)
    for i in range(steps):
        batch = batches[i % len(batches)]
        flags = cadence.flags_for_step(i, 0)
        sync(device)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch, lr, kfac.hparams.damping, **flags)
        out["losses"].append(float(m["loss"]))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["kinds"].append(step_kind(flags))
        if flags.get("flush_factors"):
            out["flush_digests"].append((i, tensor_digest(
                t for f in state.kfac_state["factors"].values() for t in f.values()),
                tensor_digest(model.parameters())))
        if flags.get("flush_factors") and "wire_error" in state.kfac_state:
            facs = torch.sqrt(sum(torch.sum(t.float() ** 2) for f in
                                  state.kfac_state["factors"].values() for t in f.values()))
            out["flush_residual"].append(
                (i, float(publish_wire_quant_error(state.kfac_state["wire_error"])), float(facs)))
    out["launches"] = read_counts(counters)
    hist = {"loss": out["losses"], "kind": out["kinds"], "val_loss": []}
    if twin == "lm":
        out["expected_launches"] = {LM_COUNTERS[k]: n for k, n in
                                    lm_expected_launches(hist, model).items()}
    else:
        out["expected_launches"] = wikitext_expected(hist, embedding=args.kfac_embedding)
    out["wire_bytes"] = kfac.factor_comm.last_wire_bytes
    out["bucket_sizes"] = [b.size for b in kfac.factor_comm._plan_for(
        [t for f in state.kfac_state["factors"].values() for t in f.values()])]
    # the collectives' host time on a flush step and a capture step
    exchange = {}
    freq = kfac.factor_comm.comm_freq
    kinds = (("flush", 2 * freq * steps),) if kfac.factor_comm.defer else ()
    for label, i in (*kinds, ("capture", 2 * freq * steps + 1)):
        flags = kfac_flags_for_step(i, kfac, 0)
        if step_kind(flags) != label:
            raise AssertionError(f"step {i} is a {step_kind(flags)} step, want {label}")
        sync(device)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            state, m = step_fn(state, batches[0], lr, kfac.hparams.damping, **flags)
            float(m["loss"])
        ops = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
               if e.key.startswith("gloo:")}
        exchange[label] = {"ms": sum(ops.values()), "ops": ops}
    out["exchange_ms"] = exchange
    if keep is not None:
        keep.update(model=model, kfac=kfac, state=state, step_fn=step_fn, batches=batches)
    return out


def comm_worker(rank, store, out_path, steps, device_name, runs):
    """One rank of phases 22b-c (``torch.multiprocessing`` target): each of
    ``runs`` (``COMM_RUNS``) on ``cuda:0`` over gloo; writes its results as
    JSON to ``out_path-<rank>.json``."""
    import torch

    from kfac_pytorch_tpu_torch.device import use_ieee_f32
    from kfac_pytorch_tpu_torch.parallel import launch
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world

    device = launch.initialize(device_name, backend="gloo", init_method=f"file://{store}",
                               rank=rank, world_size=2)
    try:
        use_ieee_f32()
        world = data_parallel_world()
        result = {"rank": rank, "device": str(device),
                  "backend": torch.distributed.get_backend(), "runs": {}}
        for name, twin, argv in runs:
            result["runs"][name] = _comm_run(twin, argv, device, world, steps)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        with open(f"{out_path}-{rank}.json", "w") as fh:
            json.dump(result, fh)
    finally:
        torch.distributed.destroy_process_group()


def merge_peak(device, n=WIKITEXT2_VOCAB):
    """A whole int8 flush merge (``FactorComm._merge_quantized``) of one
    ``n × n`` G factor, WikiText-2's decoder G and a bucket of its own, on
    NCCL at world size 1: the peak memory above the factor and its
    residual, their bytes, and the time; the merge lands in the factor's
    and the residual's own storage, and factor + residual is unchanged."""
    import torch
    import torch.distributed as dist

    from kfac_pytorch_tpu_torch.parallel.comm import FactorComm
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world

    def run():
        torch.cuda.set_device(device)
        dist.init_process_group("nccl")
        dist.all_reduce(torch.zeros(1, device=device))  # NCCL's set-up, untimed
        fc = FactorComm(data_parallel_world(), "int8", 2)
        gen = torch.Generator(device=device).manual_seed(0)
        g = torch.empty((n, n), dtype=torch.float32, device=device).normal_(generator=gen)
        tree = {"decoder": {"G": g}}
        err = fc.wire_error_init(tree)
        err["b0"].normal_(std=1e-3, generator=gen)
        k = 1 << 20
        before = (g.view(-1)[:k] + err["b0"][:k]).double()
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        merged, new_err = fc._merge_quantized(tree, err, 0)
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(device) - base
        out_g = merged["decoder"]["G"]
        if out_g.data_ptr() != g.data_ptr() or new_err["b0"].data_ptr() != err["b0"].data_ptr():
            raise AssertionError("the int8 merge did not land in the factor's and the "
                                 "residual's storage")
        after = (out_g.view(-1)[:k] + new_err["b0"][:k]).double()
        drift = float((after - before).abs().max() / before.abs().max())
        if not (torch.isfinite(out_g).all() and drift <= 1e-6):
            raise AssertionError(f"int8 merge at world 1: factor + residual moved by {drift}")
        res = {"elements": n * n, "factor_bytes": g.numel() * 4,
               "residual_bytes": new_err["b0"].numel() * 4, "peak_above_bytes": peak,
               "codes_bytes": -(-n * n // 256) * 256, "wire_bytes": fc.last_wire_bytes,
               "ms": ms, "sum_rel_drift": drift}
        del g, tree, err, merged, new_err, out_g
        return res

    out, _, _ = in_nccl_world1(run)
    torch.cuda.empty_cache()
    return out


def comm_phase(device, ranks):
    """Phases 22b-c: ``ranks``, :func:`comm_worker`'s two ranks on the one
    card, ``COMM_RUNS`` in each (see
    the module docstring for the gates), one process on the concatenated
    LM batch, and the int8 flush merge's peak at WikiText-2's width."""
    import torch

    from kfac_pytorch_tpu_torch.parallel.comm import quant_wire_bytes
    from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step

    for res in ranks:
        for name, run in res["runs"].items():
            gate_launches(run["launches"], run["expected_launches"],
                          f"rank {res['rank']}, {name}")
            if not all(math.isfinite(v) for v in run["losses"]):
                raise AssertionError(f"rank {res['rank']}, {name}: losses {run['losses']}")
    runs = ranks[0]["runs"]
    # a flush merges the ranks' factors into one mean, and the parameters
    # follow the ranks' mean gradient: both bitwise equal across the ranks
    for name, run in runs.items():
        if "flush_digests" not in run:  # the CIFAR twin runs through its main()
            continue
        other = ranks[1]["runs"][name]["flush_digests"]
        if not run["flush_digests"] or other != run["flush_digests"]:
            raise AssertionError(f"{name}: the ranks' factors or parameters differ after a "
                                 f"flush: {run['flush_digests']} against {other}")
    if "flush" not in runs["cifar_bf16"]["kinds"]:
        raise AssertionError(f"CIFAR twin's step kinds {runs['cifar_bf16']['kinds']}")
    # one process on the concatenated global batch, the f32 run's first steps
    step_fn, state, kfac, batches, args = lm_setup(device, ["--batch-size", str(2 * 4)])
    one = []
    for i in range(ORACLE_STEPS):
        state, m = step_fn(state, batches[i], args.base_lr, kfac.hparams.damping,
                           **kfac_flags_for_step(i, kfac, 0))
        one.append(float(m["loss"]))
    del state, step_fn, kfac, batches
    torch.cuda.empty_cache()
    worst = gate_oracle(runs["lm_f32"]["losses"], one, "LM, two ranks vs one process",
                        range(ORACLE_STEPS))
    bf16_rel = gate_oracle(runs["lm_bf16"]["losses"], runs["lm_f32"]["losses"],
                           "LM, bf16 wires vs the f32 wire", range(COMM_STEPS), COMM_BF16_RTOL)
    int8_rel = gate_oracle(runs["lstm_int8"]["losses"], runs["lstm_f32"]["losses"],
                           "LSTM, int8 wire vs the f32 wire", range(COMM_STEPS), COMM_INT8_RTOL)
    if runs["lm_bf16"]["wire_bytes"] * 2 != runs["lm_f32"]["wire_bytes"]:
        raise AssertionError(f"bf16 factor wire {runs['lm_bf16']['wire_bytes']} bytes, the f32 "
                             f"wire's {runs['lm_f32']['wire_bytes']}")
    sizes = runs["lstm_int8"]["bucket_sizes"]
    if (runs["lstm_int8"]["wire_bytes"], runs["lstm_f32"]["wire_bytes"]) != (
            quant_wire_bytes(sizes), 4 * sum(sizes)):
        raise AssertionError(f"LSTM wire bytes {runs['lstm_int8']['wire_bytes']} (int8) and "
                             f"{runs['lstm_f32']['wire_bytes']} (f32) for buckets {sizes}")
    int8_over_bf16 = runs["lstm_int8"]["wire_bytes"] / (2 * sum(sizes))
    for res in ranks:
        flushes = res["runs"]["lstm_int8"]["flush_residual"]
        if not flushes or any(not 0 < e <= RESIDUAL_BOUND * f for _, e, f in flushes):
            raise AssertionError(f"rank {res['rank']}: int8 residual norms {flushes} (bound "
                                 f"{RESIDUAL_BOUND:.4f} of the factors' norm)")
    quant = merge_peak(device)
    print(f"two ranks, factor comm plane: LM f32 wire within {worst:.2e} of one process, bf16 "
          f"wires within {bf16_rel:.2e} of it at half the bytes "
          f"({runs['lm_bf16']['wire_bytes']}); LSTM int8 within {int8_rel:.2e} of the f32 wire, "
          f"{int8_over_bf16:.3f}x the bf16 bytes, residual/factors "
          f"{max(e / f for _, e, f in runs['lstm_int8']['flush_residual']):.2e}; collectives "
          f"(rank 0's host ms) LM flush {runs['lm_f32']['exchange_ms']['flush']['ms']:.1f}, "
          f"capture {runs['lm_f32']['exchange_ms']['capture']['ms']:.1f}; int8 merge at "
          f"33,278²: {quant['peak_above_bytes'] / 1e9:.2f} GB above the "
          f"{quant['factor_bytes'] / 1e9:.2f} GB factor and its residual, {quant['ms']:.1f} ms",
          flush=True)
    return {"ranks": ranks, "one_process_losses": one, "max_rel_diff_vs_one_process": worst,
            "bf16_max_rel_diff": bf16_rel, "int8_max_rel_diff": int8_rel,
            "int8_over_bf16_bytes": int8_over_bf16, "steps": COMM_STEPS,
            "int8_merge_33278": quant}


# Phase 23 (slice 14): owner-sharded factor state and the overlap plane.
OWNER_FLAGS = ["--factor-sharding", "owner"]
OWNER_LM_WIRES = ["--factor-comm-dtype", "bf16", "--factor-comm-freq", "2"]
# 19a's LSTM without dropout (the ranks and one process would draw other
# masks), the embedding's diagonal A (the v<V> groups), the chunked and
# rank-aware refresh
OWNER_LSTM_FLAGS = ["--kfac-embedding", "--dropout", "0", "--eigh-chunks", "2", "--solver",
                    "rsvd", "--solver-auto-threshold", "256"]
OWNER_STEPS = TWO_RANK_DEPTH
OWNER_WORLD1_STEPS = 12
OWNER_RUNS = (  # (name, twin, argv)
    ("cifar_owner", "cifar", [*RESNET_ARGS, *OWNER_FLAGS]),
    ("lm_owner_overlap", "lm", [*LM_ARGS, *OWNER_FLAGS, *OWNER_LM_WIRES, "--comm-overlap"]),
    ("lm_owner", "lm", [*LM_ARGS, *OWNER_FLAGS, *OWNER_LM_WIRES]),
    ("lm_replicated", "lm", [*LM_ARGS, *OWNER_LM_WIRES]),
    # the overlap plane's mechanism (a) acts on the per-step bucket means
    # alone (owner-sharded and deferred runs have none): serial, then on
    ("lm_replicated_serial", "lm", [*LM_ARGS, "--factor-comm-dtype", "bf16"]),
    ("lm_replicated_overlap", "lm", [*LM_ARGS, "--factor-comm-dtype", "bf16", "--comm-overlap"]),
    ("lstm_owner", "lstm", [*WIKITEXT_ARGS, *OWNER_FLAGS, *OWNER_LSTM_FLAGS]),
    ("lstm_owner_overlap", "lstm", [*WIKITEXT_ARGS, *OWNER_FLAGS, *OWNER_LSTM_FLAGS,
                                    "--comm-overlap"]),
)
OWNER_COLLECTIVES = ("reduce_scatter_tensor", "all_gather_into_tensor", "all_reduce",
                     "broadcast", "batch_isend_irecv")


def owner_world1_phase(device, counters, lm_hist):
    """Phase 23a: ``--factor-sharding owner --comm-overlap`` at NCCL world
    size 1 through the CIFAR twin (ResNet-32, 12 steps, deterministic cuDNN,
    against the same run without a group) and the LM twin (phase 8's 38
    steps, against phase 8): both levers warn and are inert, the losses
    within ``RESUME_RTOL``, the kernels as implied."""
    import contextlib
    import io

    import torch

    from kfac_pytorch_tpu_torch.models import cifar_resnet

    flags = [*OWNER_FLAGS, "--comm-overlap"]
    steps = ["--steps-per-epoch", str(OWNER_WORLD1_STEPS)]
    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = io.StringIO()
    try:
        plain = train(steps)
        with contextlib.redirect_stdout(out):
            (hist, launches), _, _ = in_nccl_world1(
                lambda: counted(lambda: train([*steps, *flags]), counters))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
    gate_launches(launches, conv_expected_launches(
        hist, cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0)), device),
        "ResNet-32 owner, NCCL world 1")
    (lm, lm_launches), _, _ = in_nccl_world1(
        lambda: counted(lambda: train_lm(["--epochs", str(LM_EPOCHS), *flags]), counters))
    warned = out.getvalue()
    if "factor_sharding='owner' has no effect" not in warned or \
            "comm_overlap=True has no effect" not in warned:
        raise AssertionError(f"world 1: the levers did not warn: {warned!r}")
    res = {}
    for name, got, want in (("resnet32", hist["loss"], plain["loss"]),
                            ("lm", lm["loss"], lm_hist["loss"])):
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        if len(got) != len(want) or not max(rel) <= RESUME_RTOL:
            raise AssertionError(f"{name} owner at world 1: losses {got} vs {want}")
        res[name] = {"losses_max_rel_diff": max(rel), "losses_bitwise": sum(
            a == b for a, b in zip(got, want)), "steps": len(got)}
    print(f"owner + overlap at NCCL world 1 (inert, warned): ResNet-32 "
          f"{res['resnet32']['losses_bitwise']}/{res['resnet32']['steps']} losses bitwise, LM "
          f"{res['lm']['losses_bitwise']}/{res['lm']['steps']} bitwise phase 8's", flush=True)
    return {**res, "launches": {"resnet32": launches, "lm": lm_launches}}


@contextlib.contextmanager
def dist_calls(calls):
    """Count the ``torch.distributed`` collectives of ``OWNER_COLLECTIVES``
    issued inside the block into ``calls``."""
    import torch.distributed as dist

    real = {n: getattr(dist, n) for n in OWNER_COLLECTIVES}

    def wrap(n):
        def fn(*args, **kwargs):
            calls[n] = calls.get(n, 0) + 1
            return real[n](*args, **kwargs)
        return fn

    for n in OWNER_COLLECTIVES:
        setattr(dist, n, wrap(n))
    try:
        yield calls
    finally:
        for n, f in real.items():
            setattr(dist, n, f)


def owner_apply_groups(kfac, rank):
    """The shape groups of dense entries that ``rank`` solves through kernel
    3 on every step of the owner mode: its owned "update" layers of the
    plan's gather layout with no truncated side."""
    from kfac_pytorch_tpu_torch.ops import precondition as pc

    (plan,) = kfac._shard_plans.values()
    shapes, diag = {}, set()
    for s in plan.slots:
        g, a = shapes.get(s.name, (0, 0))
        shapes[s.name] = (s.size, a) if s.factor == "G" else (g, s.size)
        if s.diag:
            diag.add(s.name)
    _, segments, _ = pc._owner_gather_layout(shapes, plan.owners, plan.world, kfac._rank_fn(),
                                             diag)
    return len({shapes[n] for n, seg in segments.items()
                if plan.owners[n] == rank and seg["mode"] == "update" and n not in diag
                and kfac._rank_for(shapes[n][0]) is None and kfac._rank_for(shapes[n][1]) is None})


def kfac_state_bytes(state):
    """The bytes of every tensor of a K-FAC state."""
    import torch

    def walk(t):
        if isinstance(t, torch.Tensor):
            return t.numel() * t.element_size()
        return sum(walk(v) for v in t.values()) if isinstance(t, dict) else 0

    return walk(state)


def _owner_cifar_run(argv, device, world, steps):
    """ResNet-32 owner-sharded on this rank: ``steps`` counted steps through
    the cadence, the parameters' digest after each; a refresh step and a
    capture step with their K-FAC collectives counted and their gloo host
    ms profiled."""
    import torch

    from kfac_pytorch_tpu_torch import EigenRefreshCadence
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.models.layers import KFACConv
    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
    from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step, step_kind

    args = trainer.parse_args(argv)
    model, kfac, state, step_fn = trainer.build(args, device, world)
    batches = _two_rank_batches(device, world.rank, steps, args.batch_size)
    lr = args.base_lr * world.size
    cadence = EigenRefreshCadence(kfac)
    counters = (fk.compute_a_conv_fused, ak.fused_precondition_stack, ak.fused_sgd_apply)
    out = {"losses": [], "kinds": [], "digests": []}
    zero_counts(counters)
    for i, batch in enumerate(batches):
        flags = cadence.flags_for_step(i, 0)
        state, m = step_fn(state, batch, lr, kfac.hparams.damping, **flags)
        out["losses"].append(float(m["loss"]))
        out["kinds"].append(step_kind(flags))
        out["digests"].append(tensor_digest(model.parameters()))
    out["launches"] = read_counts(counters)
    captures = sum(k != "plain" for k in out["kinds"])
    out["expected_launches"] = {
        "compute_a_conv_fused": captures * sum(isinstance(m, KFACConv) for m in model.modules()),
        "fused_precondition_stack": owner_apply_groups(kfac, world.rank) * steps,
        "fused_sgd_apply": steps,
    }
    (plan,) = kfac._shard_plans.values()
    out["wire_buckets"] = len(plan.wire_buckets)
    real_update = kfac.update
    out["collectives"], out["exchange_ms"] = {}, {}
    for label, i in (("refresh", 10 * steps), ("capture", 10 * steps + 1)):
        calls = {}

        def update(*a, **k):
            with dist_calls(calls):
                return real_update(*a, **k)

        kfac.update = update
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            state, m = step_fn(state, batches[0], lr, kfac.hparams.damping,
                               **kfac_flags_for_step(i, kfac, 0))
            float(m["loss"])
        del kfac.update
        ops = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
               if e.key.startswith("gloo:")}
        out["collectives"][label] = calls
        out["exchange_ms"][label] = {"ms": sum(ops.values()), "ops": ops}
    out["plan_info"] = kfac.shard_plan_info
    out["gather_width"] = kfac.precond_gather_width
    return out


def _owner_state_checks(kept, argv, device, world, root):
    """On the LM's owner ranks: the K-FAC state's bytes and its
    ``memory_allocated`` at init, owner against replicated, beside the
    plan's; an owner checkpoint saved on the ranks and restored on them
    (every shard row's digest), and a replicated one re-homed."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
    from kfac_pytorch_tpu_torch.training import checkpoint as ckpt
    from kfac_pytorch_tpu_torch.training.step import TrainState

    kfac, model, state = kept["kfac"], kept["model"], kept["state"].kfac_state
    rep_args = trainer.parse_args([a for a in argv if a not in OWNER_FLAGS])
    _, rep_kfac, rep_train, _, _ = trainer.build(rep_args, device, world=world)
    # the per-step owner plane keeps no full-size factor_local accumulator
    step_args = trainer.parse_args([*argv, "--factor-comm-freq", "1"])
    _, step_kfac, _, _, _ = trainer.build(step_args, device, world=world)
    out = {"plan_info": kfac.shard_plan_info, "gather_width": kfac.precond_gather_width}
    allocated = ((lambda: torch.cuda.memory_allocated(device)) if device.type == "cuda"
                 else (lambda: 0))
    for key, k in (("owner", kfac), ("owner_per_step", step_kfac), ("replicated", rep_kfac)):
        base = allocated()
        fresh = k.init(model)
        out[f"{key}_init_allocated_bytes"] = allocated() - base
        out[f"{key}_state_bytes"] = kfac_state_bytes(fresh)
        del fresh
    shard_keys = ("factor_shard", "eigen_shard", "eigen_pending_shard")  # this rank's rows
    rows = lambda st: tensor_digest(ckpt._tensors({k: st[k] for k in shard_keys if k in st}))  # noqa: E731
    ckpt.save_checkpoint(f"{root}/owner", 0, TrainState(1, model, {}, state), world)
    torch.distributed.barrier()  # rank 0 has written
    target = TrainState(0, model, {}, kfac.init(model))
    back = ckpt.restore_checkpoint(f"{root}/owner", 0, target, kfac)
    out["round_trip_digests"] = (rows(state), rows(back.kfac_state))
    ckpt.save_checkpoint(f"{root}/replicated", 0, TrainState(1, model, {},
                                                             rep_train.kfac_state), world)
    torch.distributed.barrier()
    target = TrainState(0, model, {}, kfac.init(model))
    rehomed = ckpt.restore_checkpoint(f"{root}/replicated", 0, target, kfac)
    out["rehome_digests"] = (rows(kfac.owner_state_from_replicated(rep_train.kfac_state)),
                             rows(rehomed.kfac_state))
    del rep_kfac, rep_train, step_kfac
    return out


def owner_chunk_recon(kept):
    """On the LSTM's owner rank: a two-chunk owner pass (the
    ``plan_owner_chunks`` jobs into zeroed pending stacks) against the
    monolithic owner refresh of the same shard stacks, through the factors
    their valid rows reconstruct: the largest difference over the largest
    entry."""
    import torch

    from kfac_pytorch_tpu_torch.parallel.assignment import plan_owner_chunks
    from kfac_pytorch_tpu_torch.parallel.sharded_eigh import (
        owner_eigen_chunk_update,
        owner_eigen_update,
    )

    kfac, state = kept["kfac"], kept["state"].kfac_state
    (plan,) = kfac._shard_plans.values()
    shard, rank, rank_fn = state["factor_shard"], kfac.world.rank, kfac._rank_fn()
    mono = owner_eigen_update(shard, plan, rank, kfac.eps, rank_fn, kfac.eigen_dtype)
    pending = {k: {f: torch.zeros_like(v) for f, v in e.items()} for k, e in mono.items()}
    for jobs in plan_owner_chunks(plan, kfac.eigh_chunks, rank_fn=rank_fn):
        pending = owner_eigen_chunk_update(shard, pending, jobs, plan, rank, kfac.eps, rank_fn,
                                           kfac.eigen_dtype)
    worst = 0.0
    for n in plan.group_sizes:
        for i, ok in enumerate(plan.valid_rows(n)[rank]):
            if not ok:
                continue
            recon = []
            for e in (pending[f"n{n}"], mono[f"n{n}"]):
                q = e["Q"][i].double()
                f = (q * e["d"][i].double()) @ q.T
                if "rho" in e:
                    f += float(e["rho"][i]) * (torch.eye(n, dtype=f.dtype, device=f.device) - q @ q.T)
                recon.append(f)
            worst = max(worst, float((recon[0] - recon[1]).abs().max() / recon[1].abs().max()))
    return worst


def owner_worker(rank, store, out_path, steps, device_name, runs):
    """One rank of phases 23b-d (``torch.multiprocessing`` target): each of
    ``runs`` (``OWNER_RUNS``) on ``cuda:0`` over gloo, then the LM's state
    checks (checkpoints under ``out_path-ck``) and the LSTM's chunked pass;
    writes its results as JSON to ``out_path-<rank>.json``."""
    import torch

    from kfac_pytorch_tpu_torch.device import use_ieee_f32
    from kfac_pytorch_tpu_torch.parallel import launch
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world

    device = launch.initialize(device_name, backend="gloo", init_method=f"file://{store}",
                               rank=rank, world_size=2)
    try:
        use_ieee_f32()
        world = data_parallel_world()
        result = {"rank": rank, "backend": torch.distributed.get_backend(), "runs": {}}
        for name, twin, argv in runs:
            if twin == "cifar":
                res = _owner_cifar_run(argv, device, world, steps)
            else:
                kept = {}
                res = _comm_run(twin, argv, device, world, steps, kept)
                if "--factor-sharding" in argv:
                    res["expected_launches"]["fused_precondition_stack"] = owner_apply_groups(
                        kept["kfac"], rank) * steps
                    res["plan_info"] = kept["kfac"].shard_plan_info
                if name == "lm_owner":
                    res["state_checks"] = _owner_state_checks(kept, argv, device, world,
                                                              f"{out_path}-ck")
                if name == "lstm_owner":
                    res["chunk_recon_max_rel_diff"] = owner_chunk_recon(kept)
                del kept
            result["runs"][name] = res
            if device.type == "cuda":
                torch.cuda.empty_cache()
        with open(f"{out_path}-{rank}.json", "w") as fh:
            json.dump(result, fh)
    finally:
        torch.distributed.destroy_process_group()


def wikitext2_plan_bytes():
    """Host only: ``shard_plan_bytes`` of the WikiText-2 LSTM's K-FAC layers
    (the 33,278-word decoder, and the embedding with ``--kfac-embedding``)
    for 2, 4 and 8 ranks, under the dense eigh and ``--solver rsvd``
    (the twin's rank 128 from side 512)."""
    from kfac_pytorch_tpu_torch.parallel.assignment import plan_factor_shards, shard_plan_bytes

    shapes = {"decoder": (WIKITEXT2_VOCAB, 651), "encoder": (650, WIKITEXT2_VOCAB)}
    out = {}
    for solver, rank_fn in (("eigh", None), ("rsvd", lambda n: None if n < 512 else 128)):
        for world in (2, 4, 8):
            info = shard_plan_bytes(plan_factor_shards(shapes, world, diag_a={"encoder"}),
                                    rank_fn=rank_fn)
            out[f"{solver}_world{world}"] = {k: info[k] for k in (
                "total_buffer_local", "replicated_total", "per_owner", "owner_count")}
    return out


def owner_phase(device, ranks):
    """Phases 23b-d: ``ranks``, :func:`owner_worker`'s two ranks on the one
    card (20c's setup), ``OWNER_RUNS``
    in each (see the module docstring for the gates), one process on the
    concatenated ResNet-32 and LSTM batches, and the plan's bytes at
    WikiText-2's width."""
    import torch

    from kfac_pytorch_tpu_torch import EigenRefreshCadence
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    for res in ranks:
        for name, run in res["runs"].items():
            gate_launches(run["launches"], run["expected_launches"],
                          f"rank {res['rank']}, {name}")
            if not all(math.isfinite(v) for v in run["losses"]):
                raise AssertionError(f"rank {res['rank']}, {name}: losses {run['losses']}")
        cif = res["runs"]["cifar_owner"]
        want = {"reduce_scatter_tensor": cif["wire_buckets"], "all_gather_into_tensor": 1}
        for label, calls in cif["collectives"].items():
            if calls != want:
                raise AssertionError(f"rank {res['rank']}: the owner {label} step's K-FAC "
                                     f"collectives {calls}, want {want}")
        checks = res["runs"]["lm_owner"]["state_checks"]
        for key in ("round_trip_digests", "rehome_digests"):
            if checks[key][0] != checks[key][1]:
                raise AssertionError(f"rank {res['rank']}: {key} differ: {checks[key]}")
        if not res["runs"]["lstm_owner"]["chunk_recon_max_rel_diff"] <= EIGH_TOL:
            raise AssertionError(f"rank {res['rank']}: a chunked owner pass "
                                 f"{res['runs']['lstm_owner']['chunk_recon_max_rel_diff']:.2e} "
                                 f"from the monolithic owner refresh (tolerance {EIGH_TOL})")
    runs = ranks[0]["runs"]
    if runs["cifar_owner"]["digests"] != ranks[1]["runs"]["cifar_owner"]["digests"]:
        raise AssertionError("ResNet-32 owner: the ranks' parameters differ after a step")
    for name, run in runs.items():  # the parameters follow the ranks' one mean
        other = ranks[1]["runs"][name].get("flush_digests")
        if "flush_digests" in run and other != run["flush_digests"]:
            raise AssertionError(f"{name}: the ranks' parameters differ after a flush")
    # overlap reorders the wire only: the LM bitwise, the LSTM (cuDNN's RNN
    # may not repeat bitwise) within RESUME_RTOL
    for a, b in (("lm_owner_overlap", "lm_owner"),
                 ("lm_replicated_overlap", "lm_replicated_serial")):
        if runs[a]["losses"] != runs[b]["losses"]:
            raise AssertionError(f"LM: overlap changed the losses: {runs[a]['losses']} "
                                 f"against {runs[b]['losses']}")
    overlap_lstm = gate_oracle(runs["lstm_owner_overlap"]["losses"], runs["lstm_owner"]["losses"],
                               "LSTM overlap on vs off", range(OWNER_STEPS), RESUME_RTOL)
    lm_rel = gate_oracle(runs["lm_owner_overlap"]["losses"], runs["lm_replicated"]["losses"],
                         "LM owner vs replicated, same wires", range(OWNER_STEPS))
    # one process on the concatenated batches: ResNet-32's first steps, the
    # LSTM's twelve
    args = trainer.parse_args(RESNET_ARGS)
    parts = [_two_rank_batches(device, r, ORACLE_STEPS, args.batch_size) for r in range(2)]
    args.batch_size *= 2
    _, kfac, state, step_fn = trainer.build(args, device)
    cadence, one = EigenRefreshCadence(kfac), []
    for i in range(ORACLE_STEPS):
        batch = tuple(torch.cat([parts[0][i][j], parts[1][i][j]]) for j in range(2))
        state, m = step_fn(state, batch, args.base_lr * 2, kfac.hparams.damping,
                           **cadence.flags_for_step(i, 0))
        one.append(float(m["loss"]))
    del state, step_fn, kfac
    cifar_rel = gate_oracle(runs["cifar_owner"]["losses"], one, "ResNet-32 owner vs one process",
                            range(ORACLE_STEPS))
    step_fn, state, kfac, batches, wargs = wikitext_setup(device, OWNER_LSTM_FLAGS)
    cadence, lstm_one = EigenRefreshCadence(kfac), []
    for i in range(OWNER_STEPS):
        state, m = step_fn(state, batches[i], wargs.base_lr, kfac.hparams.damping,
                           **cadence.flags_for_step(i, 0))
        lstm_one.append(float(m["loss"]))
    del state, step_fn, kfac, batches
    torch.cuda.empty_cache()
    lstm_rel = gate_oracle(runs["lstm_owner"]["losses"], lstm_one, "LSTM owner vs one process",
                           range(OWNER_STEPS))
    medians = {name: kind_medians({"kind": run["kinds"], "step_ms": run["step_ms"]})
               for name, run in runs.items() if "step_ms" in run}
    plan_bytes = wikitext2_plan_bytes()
    checks = runs["lm_owner"]["state_checks"]
    print(f"two ranks, owner-sharded: ResNet-32 within {cifar_rel:.2e} of one process, the "
          f"capture step {runs['cifar_owner']['wire_buckets']} reduce-scatters + 1 all-gather, "
          f"the refresh no more; LM owner within {lm_rel:.2e} of replicated, overlap bitwise; "
          f"LSTM within {lstm_rel:.2e} of one process, a chunked pass "
          f"{runs['lstm_owner']['chunk_recon_max_rel_diff']:.2e} from the monolithic one; LM "
          f"K-FAC state {checks['owner_state_bytes']} bytes owner (deferred), "
          f"{checks['owner_per_step_state_bytes']} owner per step, "
          f"{checks['replicated_state_bytes']} replicated (plan: "
          f"{checks['plan_info']['total_buffer_local']} of "
          f"{checks['plan_info']['replicated_total']}); LM medians {json.dumps(medians)}",
          flush=True)
    return {"ranks": ranks, "one_process_losses": {"resnet32": one, "lstm": lstm_one},
            "resnet32_max_rel_diff_vs_one_process": cifar_rel,
            "lm_owner_max_rel_diff_vs_replicated": lm_rel,
            "lstm_max_rel_diff_vs_one_process": lstm_rel, "step_ms_medians": medians,
            "lstm_overlap_max_rel_diff": overlap_lstm,
            "wikitext2_plan_bytes": plan_bytes, "steps": OWNER_STEPS}


# Phase 24 (slice 15): the LM's extras and sequence parallelism.
LENS_FLAGS = ["--qkv-lens"]
# (seq_len, batch) of the remat memory figures
REMAT_MEMORY_CASES = ((2048, 4), (8192, 1))
# flash backward against float64 at long sequences: T, D, and [B, H]
FLASH_LONG_T = (4096, 8192, 16384)
FLASH_LONG_D = (64, 128)
FLASH_LONG_BH = (1, 2)
FLASH_BWD_TOL = 1e-4
# flash_dkv's spill store bytes per head width in run AG (PR 15): a
# redesign of its sums may not spill more
FLASH_DKV_SPILL_LIMIT = {32: 16, 64: 0, 128: 76}
SEQ_KINDS = ("ring", "ulysses")
SEQ_STEPS = TWO_RANK_DEPTH


def lens_phase(device, counters, lm_stats):
    """Phase 24a: phase 8's LM recipe with ``--qkv-lens`` through the twin
    (its 38 steps): kernels 2-7 as implied, kernel 3 on 4 shape groups a
    step; the loss finite and falling; the first ``ORACLE_STEPS`` losses
    within 1e-3 of the oracle path's with the lens; the capture and
    refresh step medians beside phase 8's; kernel 3 at the lensed groups
    against its plain version (``apply_phase``)."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    hist, launches = counted(lambda: train_lm(["--epochs", str(LM_EPOCHS), *LENS_FLAGS]), counters)
    first, last = gate_falling(hist["loss"], "LM --qkv-lens")
    args = trainer.parse_args([*LM_ARGS, *LENS_FLAGS])
    model = trainer.build(args, device)[0]
    expected = lm_expected_launches(hist, model)
    groups = expected["fused_apply"] // len(hist["loss"])
    if groups != 4:
        raise AssertionError(f"LM --qkv-lens: {groups} apply shape groups a step, not 4")
    expected = {LM_COUNTERS[k]: n for k, n in expected.items()}
    gate_launches(launches, expected, "LM --qkv-lens")
    apply_row = apply_phase(model, device)
    apply_row["launches"] = launches["fused_precondition_stack"]
    apply_row["launches_per_step"] = apply_row["launches"] / len(hist["loss"])
    del model
    torch.cuda.empty_cache()
    oracle = lm_oracle_losses(device, ORACLE_STEPS, LENS_FLAGS)
    worst = gate_oracle(hist["loss"], oracle, "LM --qkv-lens", range(ORACLE_STEPS))
    stats = step_stats(hist, args.batch_size * args.seq_len)
    print(f"LM --qkv-lens: {groups} apply groups a step; capture step "
          f"{stats['capture_ms_median']:.2f} ms (phase 8 {lm_stats['capture_ms_median']:.2f}), "
          f"refresh step {stats['refresh_ms_median']:.2f} ms (phase 8 "
          f"{lm_stats['refresh_ms_median']:.2f}); first {ORACLE_STEPS} losses within "
          f"{worst:.2e} of the oracle path", flush=True)
    return {
        "flags": LENS_FLAGS, "steps": len(hist["loss"]), "loss_first5": first,
        "loss_last5": last, "val_loss": hist["val_loss"], "oracle_losses": oracle,
        "oracle_max_rel_diff": worst, "apply_shape_groups": groups,
        "capture_step_ms_median": stats["capture_ms_median"],
        "refresh_step_ms_median": stats["refresh_ms_median"],
        "phase8_capture_step_ms_median": lm_stats["capture_ms_median"],
        "phase8_refresh_step_ms_median": lm_stats["refresh_ms_median"],
        "launches": launches, "expected_launches": expected,
    }, apply_row


def lm_peak_bytes(seq_len, batch, remat):
    """``torch.cuda.max_memory_allocated`` over a two-step run of the LM
    twin at ``seq_len`` and ``batch`` (a refresh and a capture step, and
    the validation), less what was allocated before it. Earlier runs'
    garbage is collected first: freed during the run, it would hide part
    of the peak."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_lm(["--seq-len", str(seq_len), "--batch-size", str(batch), "--epochs", "1",
              "--steps-per-epoch", "2", *(["--remat"] if remat else [])])
    return torch.cuda.max_memory_allocated() - base


def remat_phase(device, counters, lm_hist):
    """Phase 24b: phase 8's LM recipe with ``--remat`` for its first epoch:
    every loss within ``RESUME_RTOL`` of phase 8's; kernel 5 twice per
    layer and training step, kernels 2, 3, 4, 6 and 7 as without remat; the
    dense A statistics computed once per layer and capture step
    (``compute_a_dense`` counted); the peak device memory with and without
    remat at T 2048 and batch 4 and at T 8192 and batch 1; one dropout-0.1
    step through the model API, remat on and off, bitwise equal
    gradients."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
    from kfac_pytorch_tpu_torch.models import transformer_lm
    from kfac_pytorch_tpu_torch.models.layers import KFACDense
    from kfac_pytorch_tpu_torch.ops import factors
    from kfac_pytorch_tpu_torch.ops.flash_attention import best_attention_fn
    from kfac_pytorch_tpu_torch.training import data as data_lib
    from kfac_pytorch_tpu_torch.training.step import softmax_cross_entropy

    # Python calls, eager and while a graph captures: a replay repeats the
    # capture's computations without calling Python
    a_calls, a_captured = [0], [0]
    real = factors.compute_a_dense

    def counting(*args, **kwargs):
        a_calls[0] += 1
        a_captured[0] += torch.cuda.is_current_stream_capturing()
        return real(*args, **kwargs)

    factors.compute_a_dense = counting
    try:
        hist, launches = counted(lambda: train_lm(["--epochs", "1", "--remat"]), counters)
    finally:
        factors.compute_a_dense = real
    n = len(hist["loss"])
    rel = [abs(a - b) / abs(b) for a, b in zip(hist["loss"], lm_hist["loss"][:n])]
    if not max(rel) <= RESUME_RTOL:
        raise AssertionError(f"LM --remat: losses {hist['loss']} vs phase 8's {lm_hist['loss'][:n]}")
    args = trainer.parse_args(LM_ARGS)
    model = trainer.build(args, device)[0]
    expected = {LM_COUNTERS[k]: v for k, v in lm_expected_launches(hist, model, remat=True).items()}
    gate_launches(launches, expected, "LM --remat")
    captures = sum(k != "plain" for k in hist["kind"])
    dense = sum(isinstance(m, KFACDense) for m in model.modules())
    # the graphed step (phase 8's recipe: one captured variant, the
    # capture step) computes per replay what its capture computed once
    rec = hist.get("compiled_step")
    if rec is not None:
        if rec["graphs"] != 1:
            raise AssertionError(f"LM --remat: {rec['graphs']} graphs, the count of dense A "
                                 "computations per replay needs one")
        a_calls[0] += (rec["replays"] - 1) * a_captured[0]
    if a_calls[0] != captures * dense:
        raise AssertionError(f"LM --remat: {a_calls[0]} dense A computations, {captures} capture "
                             f"steps x {dense} dense layers imply {captures * dense}")
    del model
    memory = {}
    for t, b in REMAT_MEMORY_CASES:
        memory[f"T{t}_B{b}"] = {("remat" if r else "no_remat"): lm_peak_bytes(t, b, r)
                                for r in (False, True)}
    # dropout 0.1 through the model API: one forward/backward with remat on
    # and off from one seed
    splits, words = data_lib.synthetic_corpus(vocab_size=trainer.SYNTHETIC_VOCAB)
    toks, tgts = next(data_lib.bptt_batches(
        data_lib.batchify_tokens(splits["train"], args.batch_size), args.seq_len))
    x, y = trainer.device_batch(toks, tgts, device)
    digests = {}
    for r in (False, True):
        m = transformer_lm.get_model(
            len(words), max_len=args.seq_len, d_model=args.d_model, n_heads=args.n_heads,
            n_layers=args.n_layers, attention_fn=best_attention_fn(device), dropout=0.1,
            kfac_embedding=True, remat=r, generator=torch.Generator().manual_seed(0)).to(device)
        m.train()
        gen = torch.Generator(device=device).manual_seed(7)
        softmax_cross_entropy(m(x, generator=gen), y).backward()
        digests["remat" if r else "no_remat"] = tensor_digest([p.grad for p in m.parameters()])
        del m
    if digests["remat"] != digests["no_remat"]:
        raise AssertionError("dropout 0.1: the gradients with remat differ from those without")
    torch.cuda.empty_cache()
    bitwise = sum(a == b for a, b in zip(hist["loss"], lm_hist["loss"]))
    print(f"LM --remat: {bitwise} of {n} losses bitwise phase 8's (max rel "
          f"{max(rel):.2e}); flash forward {launches['flash_forward']} launches "
          f"({expected['flash_forward']} implied); {a_calls[0]} dense A computations; peak "
          + ", ".join(f"{k} {v['no_remat'] / 2**30:.3f} -> {v['remat'] / 2**30:.3f} GiB"
                      for k, v in memory.items())
          + "; dropout 0.1 gradients bitwise equal with and without remat", flush=True)
    return {"steps": n, "losses_max_rel_diff": max(rel), "losses_bitwise": bitwise,
            "dense_a_computations": a_calls[0], "capture_steps": captures,
            "dense_layers": dense, "peak_allocated_bytes": memory,
            "dropout_grad_digests": digests, "launches": launches,
            "expected_launches": expected}


def attention_grads_f64(q, k, v, do, causal):
    """dQ, dK and dV of causal softmax attention in float64, ``[B, T, H, D]``."""
    import torch

    q, k, v, do = (x.double() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    if causal:
        t = q.shape[1]
        pos = torch.arange(t, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bhts,bshd->bthd", p, v)
    ds = torch.einsum("bthd,bshd->bhts", do, v)
    ds = p * (ds - (do * out).sum(-1).transpose(1, 2)[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, k) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, q) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, do)
    return dq, dk, dv


def flash_long_phase(device, ptxas):
    """Phase 24c: kernels 6 and 7 (dQ; dK and dV) at T = ``FLASH_LONG_T``
    (4096, 8192 and 16384), D = 64 and 128 (causal, [B, H] =
    ``FLASH_LONG_BH``) against float64: the largest difference over the
    largest entry, beside the float32 plain version's own error, fails past
    ``FLASH_BWD_TOL`` (1e-4). Kernel 7 is also run as one chunk
    (``DKV_CHUNK_ROWS`` = T: the whole sum on the tensor cores, as before
    the chunks), its error beside the chunked one's, both timed (CUDA
    events), and the chunked run repeated bitwise. Their registers and
    spill bytes from ptxas: ``flash_dkv`` fails past
    ``FLASH_DKV_SPILL_LIMIT``."""
    import torch

    from kfac_pytorch_tpu_torch.ops import flash_attention as fa

    def dkv_one_chunk(*args):
        rows, fa.DKV_CHUNK_ROWS = fa.DKV_CHUNK_ROWS, args[0].shape[1]
        try:
            return fa.flash_backward_dkv(*args)
        finally:
            fa.DKV_CHUNK_ROWS = rows

    cases = []
    b, h = FLASH_LONG_BH
    for t in FLASH_LONG_T:
        for d in FLASH_LONG_D:
            q, k, v, do = flash_qkv(device, b, t, h, d, seed=11)
            out_p, lse_p = fa.flash_forward_plain(q, k, v, True)
            delta = (do * out_p).sum(dim=-1).transpose(1, 2).contiguous()
            got = (fa.flash_backward_dq(q, k, v, do, lse_p, delta, True),
                   *fa.flash_backward_dkv(q, k, v, do, lse_p, delta, True))
            plain = fa.flash_backward_plain(q, k, v, do, lse_p, delta, True)
            ref = attention_grads_f64(q, k, v, do, True)
            names = ("dq", "dk", "dv")
            err = {n: scaled_err(g.double(), r)[1] for n, g, r in zip(names, got, ref)}
            plain_err = {n: scaled_err(g.double(), r)[1] for n, g, r in zip(names, plain, ref)}
            args = (q, k, v, do, lse_p, delta, True)
            one = dkv_one_chunk(*args)
            one_err = {n: scaled_err(g.double(), r)[1] for n, g, r in zip(names[1:], one, ref[1:])}
            again = fa.flash_backward_dkv(*args)
            if not (torch.equal(again[0], got[1]) and torch.equal(again[1], got[2])):
                raise AssertionError(f"flash_backward_dkv at {[b, t, h, d]}: a repeat differs")
            del plain, ref, one, again
            cases.append({"shape": [b, t, h, d], "causal": True, "rel_err_vs_float64": err,
                          "plain_rel_err_vs_float64": plain_err,
                          "dkv_one_chunk_rel_err_vs_float64": one_err,
                          "dkv_chunks": -(-t // fa.DKV_CHUNK_ROWS),
                          "dkv_ms": time_ms(lambda: fa.flash_backward_dkv(*args), reps=5),
                          "dkv_one_chunk_ms": time_ms(lambda: dkv_one_chunk(*args), reps=5),
                          "within_tolerance": max(err.values()) <= FLASH_BWD_TOL})
            del q, k, v, do, out_p, lse_p, delta, got, args
            torch.cuda.empty_cache()
    spills = {fn: {"registers": v[0], "spill_store_bytes": v[1]} for fn, v in ptxas.items()
              if "flash_dq" in fn or "flash_dkv" in fn}
    worst = max(max(c["rel_err_vs_float64"].values()) for c in cases)
    print(f"flash backward vs float64 at T {FLASH_LONG_T}, D {FLASH_LONG_D}: worst "
          f"{worst:.3e} of the largest entry (tolerance {FLASH_BWD_TOL}); dK/dV ms chunked "
          "against one chunk "
          + ", ".join(f"T{c['shape'][1]} D{c['shape'][3]} {c['dkv_ms']:.3f}/"
                      f"{c['dkv_one_chunk_ms']:.3f}" for c in cases)
          + "; spills "
          + ", ".join(f"{fn} {v['spill_store_bytes']} B" for fn, v in spills.items()), flush=True)
    over = [c for c in cases if not c["within_tolerance"]]
    if over:
        raise AssertionError(f"flash backward beyond {FLASH_BWD_TOL} of the largest float64 entry: "
                             + json.dumps(over))
    for fn, v in spills.items():
        m = re.search(r"flash_dkvILi(\d+)E", fn)
        if m and v["spill_store_bytes"] > FLASH_DKV_SPILL_LIMIT[int(m.group(1))]:
            raise AssertionError(f"{fn} spills {v['spill_store_bytes']} B, more than run AG's "
                                 f"{FLASH_DKV_SPILL_LIMIT[int(m.group(1))]} B")
    return {"cases": cases, "worst_rel_err": worst, "tolerance": FLASH_BWD_TOL,
            "error": "max |kernel - float64| / max |float64| per tensor",
            "ptxas": spills}


def lm_rank(rank, store, out_path, device_name, body, world_size=2):
    """One rank of a multi-rank LM phase (``torch.multiprocessing``
    target): a gloo group of ``world_size`` ranks on ``cuda:0`` (NCCL
    refuses two ranks on one device), IEEE float32, ``body(device)``'s dict
    with the rank and backend written as JSON to ``out_path-<rank>.json``."""
    import torch

    from kfac_pytorch_tpu_torch.device import use_ieee_f32
    from kfac_pytorch_tpu_torch.parallel import launch

    device = launch.initialize(device_name, backend="gloo", init_method=f"file://{store}",
                               rank=rank, world_size=world_size)
    try:
        use_ieee_f32()
        out = {"rank": rank, "backend": torch.distributed.get_backend(), **body(device)}
        with open(f"{out_path}-{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        torch.distributed.destroy_process_group()


def twin_rank_steps(args, world, device, steps, spare=0):
    """The LM twin's ``build`` with ``args`` over ``world`` and this rank's
    first ``steps + spare`` batches; ``steps`` steps through the refresh
    cadence with kernels 2-7's counters zeroed just before, each timed, its
    kind and the parameters' digest after it. ``(record, (model, kfac,
    state, step_fn, batches))``, ``record`` holding the losses, kinds, step
    milliseconds, digests and launches."""
    import itertools

    import torch

    from kfac_pytorch_tpu_torch import EigenRefreshCadence
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
    from kfac_pytorch_tpu_torch.ops import flash_attention as fa
    from kfac_pytorch_tpu_torch.training.step import step_kind

    counters = (fk.compute_a_embed_fused, ak.fused_precondition_stack, ak.fused_sgd_apply,
                fa.flash_forward, fa.flash_backward_dq, fa.flash_backward_dkv)
    model, kfac, state, step_fn, splits = trainer.build(args, device, world=world)
    if state.fsdp is not None:
        state.fsdp.shard_(state.opt_state)  # the twin's main() does it after its broadcast
    stream = trainer.rank_rows(splits["train"], args, world)
    batches = [trainer.device_batch(x, y, device) for x, y in
               itertools.islice(trainer.rank_segments(stream, args, world), steps + spare)]
    cadence = EigenRefreshCadence(kfac)
    zero_counts(counters)
    rec = {"losses": [], "kinds": [], "step_ms": [], "digests": []}
    for i in range(steps):
        flags = cadence.flags_for_step(i, 0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i], args.base_lr, kfac.hparams.damping, **flags)
        rec["losses"].append(float(m["loss"]))
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["kinds"].append(step_kind(flags))
        rec["digests"].append(tensor_digest(list(model.parameters())))
    rec["launches"] = read_counts(counters)
    return rec, (model, kfac, state, step_fn, batches)


def seq_worker(rank, store, out_path, steps, device_name, argv, kinds):
    """One rank of phase 24d (:func:`lm_rank`): for each attention kind,
    :func:`twin_rank_steps` with ``argv`` and ``--seq-parallel 2
    --attention <kind>`` on this rank's positions, then one capture step
    profiled for the collectives' host time."""

    def body(device):
        import torch

        from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
        from kfac_pytorch_tpu_torch.models.layers import KFACDense
        from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world, data_seq_world
        from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step

        runs = {}
        for kind in kinds:
            args = trainer.parse_args([*argv, "--seq-parallel", "2", "--attention", kind])
            trainer.check_world(args, data_parallel_world())
            world = data_seq_world(args.seq_parallel, device)
            rec, (model, kfac, state, step_fn, batches) = twin_rank_steps(
                args, world, device, steps, spare=1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                state, m = step_fn(state, batches[steps], args.base_lr, kfac.hparams.damping,
                                   **kfac_flags_for_step(steps + 1, kfac, 0))
                float(m["loss"])
            ops = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
                   if e.key.startswith("gloo:")}
            if not ops:
                ops = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
                       if e.key.startswith("c10d::")}
            groups = len({(m_.out_features // m_.lens_splits, m_.in_features + 1)
                          for m_ in model.modules() if isinstance(m_, KFACDense)})
            captures = sum(k != "plain" for k in rec["kinds"])
            runs[kind] = {
                **rec,
                "expected_launches": {
                    "compute_a_embed_fused": captures, "fused_precondition_stack": groups * steps,
                    "fused_sgd_apply": steps, "flash_forward": 0, "flash_backward_dq": 0,
                    "flash_backward_dkv": 0},
                "capture_step_collectives_ms": sum(ops.values()), "collective_ops": ops,
                "seq_slot": world.seq_slot, "seq_staged": world.seq_staged,
                "local_positions": batches[0][0].shape[1],
            }
            del model, kfac, state, step_fn, batches
            if device.type == "cuda":
                torch.cuda.empty_cache()
        return {"runs": runs}

    lm_rank(rank, store, out_path, device_name, body)


def seq_parallel_phase(ranks, oracle, argv=LM_ARGS):
    """Phase 24d: two ranks on the one card train phase 8's LM recipe with
    ``--seq-parallel 2`` (T 2048, 1024 positions a rank), ring and Ulysses
    attention, ``SEQ_STEPS`` steps with a refresh: kernels 2-4 launch in
    each rank as implied and kernels 5-7 never (no flash kernel under
    sequence parallelism, as in the JAX package); the parameters' digests
    equal on both ranks after every step; the first ``ORACLE_STEPS`` losses
    within 1e-3 of one process training the same global batch with full
    attention (phase 9's oracle path); step medians by kind and the
    collectives' host milliseconds per capture step. ``ranks`` are
    :func:`seq_worker`'s two ranks' results."""
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    args = trainer.parse_args(argv)  # one data slot: the global batch is one rank's rows
    out = {"ranks": ranks, "steps": SEQ_STEPS, "one_process_full_attention_losses": oracle}
    for kind in SEQ_KINDS:
        runs = [r["runs"][kind] for r in ranks]
        for r, run in zip(ranks, runs):
            for name, n in run["expected_launches"].items():
                if run["launches"][name] != n:
                    raise AssertionError(f"--attention {kind}, rank {r['rank']}: {name} launched "
                                         f"{run['launches'][name]} times, the run implies {n}")
        if runs[0]["digests"] != runs[1]["digests"]:
            raise AssertionError(f"--attention {kind}: the ranks' parameters differ")
        if runs[0]["losses"] != runs[1]["losses"]:
            raise AssertionError(f"--attention {kind}: the ranks' losses differ")
        if "refresh" not in runs[0]["kinds"][1:]:
            raise AssertionError(f"--attention {kind}: no refresh after step 0")
        worst = gate_oracle(runs[0]["losses"], oracle, f"--seq-parallel 2 --attention {kind}",
                            range(ORACLE_STEPS))
        stats = step_stats({"step_ms": runs[0]["step_ms"], "kind": runs[0]["kinds"]},
                           args.batch_size * args.seq_len)
        out[kind] = {"max_rel_diff_vs_one_process": worst,
                     "capture_step_ms_median": stats.get("capture_ms_median"),
                     "refresh_step_ms_median": stats.get("refresh_ms_median"),
                     "tokens_per_s": stats["per_s"],
                     "capture_step_collectives_ms": [r["capture_step_collectives_ms"] for r in runs]}
        print(f"--seq-parallel 2 --attention {kind} (two ranks, gloo): kernels 2-4 as implied, "
              f"5-7 never; digests equal every step; first {ORACLE_STEPS} losses within "
              f"{worst:.2e} of one process; capture step {out[kind]['capture_step_ms_median']:.1f} "
              f"ms, refresh {out[kind]['refresh_step_ms_median']:.1f} ms; collectives "
              f"{runs[0]['capture_step_collectives_ms']:.1f} ms per capture step (rank 0's host "
              "time)", flush=True)
    return out


MOE_FLAGS = ["--moe-experts", "4"]
TP_STEPS = 12
# the two ranks against one process: float32 rounding
TP_RTOL = 1e-5


def lm_moe_setup(device, extra=()):
    """``lm_setup`` with ``--moe-experts 4`` for ``one_step_oracle``: its
    ``--factor-kernel dense --apply-kernel dense`` select the oracle path
    (exact attention, dense factor and apply routes)."""
    extra = list(extra)
    oracle = "--factor-kernel" in extra
    if oracle:
        extra = extra[:extra.index("--factor-kernel")]
    return lm_setup(device, [*MOE_FLAGS, *extra], oracle=oracle)


def tp_setup(device, extra=()):
    """The ``tensor_parallel=2`` lens model at the LM path's widths, with
    the twin's hyperparameters, seed and batches, through the library API:
    ``(step_fn, state, kfac, batches, args)`` (``lm_setup``'s contract,
    ``--factor-kernel dense --apply-kernel dense`` the oracle path)."""
    import torch

    from kfac_pytorch_tpu_torch import KFAC, capture
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
    from kfac_pytorch_tpu_torch.models import transformer_lm
    from kfac_pytorch_tpu_torch.ops.flash_attention import best_attention_fn
    from kfac_pytorch_tpu_torch.parallel.context import full_attention
    from kfac_pytorch_tpu_torch.training import data as data_lib
    from kfac_pytorch_tpu_torch.training.step import TrainState, make_sgd, make_train_step

    extra = list(extra)
    oracle = "--factor-kernel" in extra
    if oracle:
        extra = extra[:extra.index("--factor-kernel")]
    args = trainer.parse_args([*LM_ARGS, *extra])
    splits, words = trainer.load_corpus(args)
    model = transformer_lm.get_model(
        len(words), max_len=args.seq_len, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, attention_fn=full_attention if oracle else best_attention_fn(device),
        kfac_embedding=True, tensor_parallel=2,
        generator=torch.Generator().manual_seed(args.seed)).to(device)
    kfac = KFAC(layers=capture.discover_layers(model), factor_decay=args.stat_decay,
                damping=args.damping, kl_clip=args.kl_clip,
                fac_update_freq=args.kfac_cov_update_freq, kfac_update_freq=args.kfac_update_freq,
                factor_kernel="dense" if oracle else "auto",
                apply_kernel="dense" if oracle else "auto", device=device)
    tx = make_sgd(momentum=args.momentum, weight_decay=args.wd)
    state = TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())),
                       kfac_state=kfac.init(model))
    step_fn = make_train_step(model, tx, kfac, sgd_hyper=(args.momentum, args.wd),
                              grad_clip=args.grad_clip)
    stream = data_lib.batchify_tokens(splits["train"], args.batch_size)
    batches = [trainer.device_batch(toks, tgts, device)
               for toks, tgts in data_lib.bptt_batches(stream, args.seq_len)]
    return step_fn, state, kfac, batches, args


def moe_dispatch_phase(ids, experts, launches):
    """Kernel 2 as the MoE dispatch (vocab = E) on the main path's expert
    ids: bitwise against its plain version and the oracle, one launch and
    no other device event per call, timed against ``torch.bincount`` and
    its bound; ``launches`` is kernel 2's count on phase 25a's path."""
    import torch

    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
    from kfac_pytorch_tpu_torch.ops import factors

    got = fk.dispatch_compute_a_moe(ids, experts)
    want = fk.compute_a_embed_fused_plain(ids, experts)
    if not (torch.equal(got, want) and torch.equal(got, factors.compute_a_embed(ids, experts))):
        raise AssertionError("the MoE dispatch through kernel 2 is not bitwise equal to its "
                             f"plain version: max |diff| {float((got - want).abs().max()):.3e}")

    def call():
        fk.dispatch_compute_a_moe(ids, experts)

    device_ms, per_call, other = kernel_spans(call, "token_count")
    if per_call != 1 or other:
        raise AssertionError(f"MoE dispatch: {per_call} kernel launches and {other} other device "
                             "events per call; want 1 and 0")
    n = ids.numel()
    b_ms, b_by = bound_ms([(ids.element_size() * n + 4 * experts, n)])
    wrapper_ms = time_ms(call)
    return {
        "name": "token_count (MoE expert fractions, vocab = E)",
        "route": "cuda",
        "source": "kfac_pytorch_tpu_torch/csrc/token_count.cu",
        "replaces": "kfac_pytorch_tpu/ops/factor_kernels.py:471",
        "unit": (f"one MoE bank's capture: {n} int64 top-1 expert ids of the last capture "
                 f"step, {experts} experts (ops/factor_kernels.py::dispatch_compute_a_moe)"),
        "max_abs_err": float((got - want).abs().max()),
        "tolerance": "bitwise",
        "fractions": got.tolist(),
        "ms": wrapper_ms,
        "wrapper_ms_is": "wall time per call of back-to-back calls (CUDA events)",
        "device_ms": device_ms,
        "device_ms_is": "profiler kernel span per call",
        "device_launches_per_call": per_call,
        "plain_ms": time_ms(lambda: fk.compute_a_embed_fused_plain(ids, experts)),
        "library_ms": time_ms(lambda: torch.bincount(ids, minlength=experts).float() / n),
        "library": "torch.bincount(ids, minlength=E).float() / N",
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bound_note": "below any launch: one launch is the practical floor",
        "launches": launches,
    }


def moe_phase(device, counters, lm_stats):
    """Phase 25a: phase 8's recipe with ``--moe-experts 4`` through the twin
    for one epoch, the counters zeroed just before: the loss finite and
    falling; kernel 2 five times per capture step and kernels 3-7 as
    phase 8 has them; the one-step oracle; the step medians beside phase
    8's; the experts idle at the last capture step; kernel 2 on that
    step's expert ids (``moe_dispatch_phase``)."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk

    seen = []  # (ids, fractions) of each MoE bank's last capture
    built = []  # the twin run's model
    dispatch, build = fk.dispatch_compute_a_moe, trainer.build

    def spy(ids, experts, *, kind="auto"):
        out = dispatch(ids, experts, kind=kind)
        seen.append((ids, out))
        del seen[:-8]
        return out

    def build_spy(*a, **kw):
        out = build(*a, **kw)
        built.append(out[0])
        return out

    fk.dispatch_compute_a_moe, trainer.build = spy, build_spy
    try:
        hist, launches = counted(lambda: train_lm(["--epochs", "1", *MOE_FLAGS]), counters)
    finally:
        fk.dispatch_compute_a_moe, trainer.build = dispatch, build
    first, last = gate_falling(hist["loss"], "LM --moe-experts 4")
    args = trainer.parse_args([*LM_ARGS, *MOE_FLAGS])
    model = built[0]
    layers = len(model.blocks)
    expected = lm_expected_launches(hist, model)
    captures = expected["token_count"]
    expected["token_count"] = captures * (1 + layers)
    groups = expected["fused_apply"] // len(hist["loss"])
    if groups != 3:
        raise AssertionError(f"LM --moe-experts: {groups} apply shape groups a step, not 3 "
                             "(qkv, out, decoder; the banks solve outside kernel 3)")
    expected = {LM_COUNTERS[k]: n for k, n in expected.items()}
    gate_launches(launches, expected, "LM --moe-experts 4")
    del model, built
    torch.cuda.empty_cache()
    kernel, oracle = one_step_oracle(lm_moe_setup, device, ORACLE_STEPS)
    worst = gate_oracle(kernel, oracle, "LM --moe-experts 4", range(ORACLE_STEPS))
    last_capture = seen[-layers:]
    idle = [int((f == 0).sum()) for _, f in last_capture]
    row = moe_dispatch_phase(last_capture[0][0], 4, launches["compute_a_embed_fused"])
    row["launches_moe_dispatch"] = captures * layers
    row["launches_are"] = (f"kernel 2's counter on phase 25a's path: the embedding's {captures} "
                           f"and the {layers} MoE banks' {captures * layers}")
    stats = step_stats(hist, args.batch_size * args.seq_len)
    print(f"LM --moe-experts 4: kernel 2 {expected['compute_a_embed_fused'] // captures} times a "
          f"capture step; capture step {stats['capture_ms_median']:.2f} ms (phase 8 "
          f"{lm_stats['capture_ms_median']:.2f}), refresh step {stats['refresh_ms_median']:.2f} "
          f"ms (phase 8 {lm_stats['refresh_ms_median']:.2f}); one-step oracle within "
          f"{worst:.2e}; idle experts at the last capture step per layer {idle}", flush=True)
    return {
        "flags": MOE_FLAGS, "steps": len(hist["loss"]), "loss_first5": first, "loss_last5": last,
        "val_loss": hist["val_loss"], "one_step_oracle": {"kernel": kernel, "oracle": oracle},
        "oracle_max_rel_diff": worst, "apply_shape_groups": groups,
        "capture_step_ms_median": stats["capture_ms_median"],
        "refresh_step_ms_median": stats["refresh_ms_median"],
        "tokens_per_s": stats["per_s"],
        "phase8_capture_step_ms_median": lm_stats["capture_ms_median"],
        "phase8_refresh_step_ms_median": lm_stats["refresh_ms_median"],
        "idle_experts_last_capture": idle,
        "expert_fractions_last_capture": [f.tolist() for _, f in last_capture],
        "launches": launches, "expected_launches": expected,
    }, row


def tp_lens_phase(device, counters, lm_stats, steps=TP_STEPS):
    """Phase 25b: the ``tensor_parallel=2`` lens model for ``steps`` steps
    (refreshes at 0 and 10), the counters zeroed just before: the stacks'
    shapes, kernels 2-7 as implied, the one-step oracle, step medians."""
    import torch

    from kfac_pytorch_tpu_torch.models.layers import KFACDense
    from kfac_pytorch_tpu_torch.training.step import kfac_flags_for_step, step_kind

    step_fn, state, kfac, batches, args = tp_setup(device)
    facs = state.kfac_state["factors"]
    shapes = {"ff1_G": tuple(facs["blocks.0.ff1#c2"]["G"].shape),
              "ff2_A": tuple(facs["blocks.0.ff2#r2"]["A"].shape)}
    half = 2 * args.d_model  # d_ff = 4·d_model over 2 shards: 1024 at d_model 512
    if shapes != {"ff1_G": (2, half, half), "ff2_A": (2, half, half)}:
        raise AssertionError(f"tensor_parallel=2: factor stacks {shapes}, want [2, {half}, {half}]")
    hist = {"loss": [], "kind": [], "step_ms": []}

    def run():
        nonlocal state
        for i in range(steps):
            flags = kfac_flags_for_step(i, kfac, 0)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, m = step_fn(state, batches[i], args.base_lr, args.damping, **flags)
            hist["loss"].append(float(m["loss"]))
            hist["step_ms"].append((time.perf_counter() - t0) * 1e3)
            hist["kind"].append(step_kind(flags))

    _, launches = counted(run, counters)
    if not all(math.isfinite(v) for v in hist["loss"]):
        raise AssertionError(f"tensor_parallel=2: non-finite loss {hist['loss']}")
    model = state.model
    groups = len({(m.out_features // m.lens_splits, m.in_features + 1)
                  for m in model.modules() if isinstance(m, KFACDense)})
    layers = len(model.blocks)
    captures = sum(k != "plain" for k in hist["kind"])
    expected = {"compute_a_embed_fused": captures, "fused_precondition_stack": groups * steps,
                "fused_sgd_apply": steps, "flash_forward": layers * steps,
                "flash_backward_dq": layers * steps, "flash_backward_dkv": layers * steps}
    gate_launches(launches, expected, "tensor_parallel=2 lens model")
    eig = state.kfac_state["eigen"]
    eig_shapes = {k: list(v.shape) for k, v in eig["blocks.0.ff1#c2"].items()}
    held = mlp_bytes(model, state.opt_state, state.kfac_state)
    del step_fn, state, kfac, batches, model
    torch.cuda.empty_cache()
    kernel, oracle = one_step_oracle(tp_setup, device, ORACLE_STEPS)
    worst = gate_oracle(kernel, oracle, "tensor_parallel=2 lens model", range(ORACLE_STEPS))
    stats = step_stats(hist, args.batch_size * args.seq_len)
    print(f"tensor_parallel=2 lens model: ff1 G {shapes['ff1_G']}, ff2 A {shapes['ff2_A']}; "
          f"{groups} apply groups a step; capture step {stats['capture_ms_median']:.2f} ms, "
          f"refresh step {stats['refresh_ms_median']:.2f} ms (phase 8 "
          f"{lm_stats['refresh_ms_median']:.2f}); one-step oracle within {worst:.2e}", flush=True)
    return {
        "steps": steps, "losses": hist["loss"], "kinds": hist["kind"], "stack_shapes": shapes,
        "ff1_eigen_shapes": eig_shapes, "apply_shape_groups": groups,
        "one_step_oracle": {"kernel": kernel, "oracle": oracle}, "oracle_max_rel_diff": worst,
        "capture_step_ms_median": stats.get("capture_ms_median"),
        "refresh_step_ms_median": stats.get("refresh_ms_median"),
        "phase8_capture_step_ms_median": lm_stats["capture_ms_median"],
        "phase8_refresh_step_ms_median": lm_stats["refresh_ms_median"],
        "launches": launches, "expected_launches": expected, "mlp_bytes": held,
    }


def tp_worker(rank, store, out_path, steps, device_name, argv):
    """One rank of phase 25c (:func:`lm_rank`): :func:`twin_rank_steps`
    with ``argv`` on the data×tensor world of ``--tensor-parallel 2``, and
    the global ranks of this rank's data subgroup."""

    def body(device):
        import torch.distributed as dist

        from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
        from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world, data_tensor_world

        args = trainer.parse_args(argv)
        trainer.check_world(args, data_parallel_world())
        world = data_tensor_world(args.tensor_parallel)
        rec = twin_rank_steps(args, world, device, steps)[0]
        return {"data": [world.rank, world.size],
                "data_group": dist.get_process_group_ranks(world.group), **rec}

    lm_rank(rank, store, out_path, device_name, body)


def tp_one_process(device, steps=TP_STEPS):
    """Phase 25c's reference: one process, no group, the same flags but
    ``--tensor-parallel``, the same steps through the refresh cadence."""
    from kfac_pytorch_tpu_torch import EigenRefreshCadence

    step_fn, state, kfac, batches, args = lm_setup(device, MOE_FLAGS)
    cadence = EigenRefreshCadence(kfac)
    losses = []
    for i in range(steps):
        state, m = step_fn(state, batches[i], args.base_lr, kfac.hparams.damping,
                           **cadence.flags_for_step(i, 0))
        losses.append(float(m["loss"]))
    return losses


def tp_phase(ranks, one, argv, steps=TP_STEPS):
    """Phase 25c: ``--tensor-parallel 2 --moe-experts 4`` on two ranks of
    the one card (``ranks``: :func:`tp_worker`'s two ranks' results) against one process
    (``one``: :func:`tp_one_process`'s losses): kernels 2-7 per rank as
    implied (kernel 2 five times per capture step, no flash kernel skipped),
    digests and losses equal on both ranks after every step, the losses
    within ``TP_RTOL`` of one process."""
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    args = trainer.parse_args(argv)
    layers = args.n_layers
    for r in ranks:  # one data slot of two tensor slots: each rank its own data subgroup
        if r["data"] != [0, 1] or r["data_group"] != [r["rank"]]:
            raise AssertionError(f"rank {r['rank']}: data slot {r['data']}, data subgroup "
                                 f"{r['data_group']}; want data [0, 1], subgroup [{r['rank']}]")
        captures = sum(k != "plain" for k in r["kinds"])
        expected = {"compute_a_embed_fused": captures * (1 + layers),
                    "fused_precondition_stack": 3 * steps, "fused_sgd_apply": steps,
                    "flash_forward": layers * steps, "flash_backward_dq": layers * steps,
                    "flash_backward_dkv": layers * steps}
        gate_launches(r["launches"], expected, f"--tensor-parallel 2 --moe-experts 4 rank "
                                               f"{r['rank']}")
        r["expected_launches"] = expected
    if ranks[0]["digests"] != ranks[1]["digests"] or ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError("--tensor-parallel 2: the tensor peers' parameters or losses differ")
    if "refresh" not in ranks[0]["kinds"][1:]:
        raise AssertionError("--tensor-parallel 2: no refresh after step 0")
    worst = gate_oracle(ranks[0]["losses"], one, "--tensor-parallel 2 --moe-experts 4 vs one "
                        "process", range(steps), rtol=TP_RTOL)
    stats = step_stats({"step_ms": ranks[0]["step_ms"], "kind": ranks[0]["kinds"]},
                       args.batch_size * args.seq_len)
    print(f"--tensor-parallel 2 --moe-experts 4 (two ranks, gloo): kernels 2-7 as implied; "
          f"digests and losses equal every step; {steps} losses within {worst:.2e} of one "
          f"process; capture step {stats.get('capture_ms_median', float('nan')):.1f} ms, refresh "
          f"{stats.get('refresh_ms_median', float('nan')):.1f} ms", flush=True)
    return {"ranks": ranks, "steps": steps, "one_process_losses": one,
            "max_rel_diff_vs_one_process": worst,
            "bitwise_vs_one_process": ranks[0]["losses"] == one,
            "capture_step_ms_median": stats.get("capture_ms_median"),
            "refresh_step_ms_median": stats.get("refresh_ms_median")}


# Phase 26 (slice 17): the 3-D data×fsdp×tensor world.
FSDP_TP_FLAGS = ["--fsdp", "1", "--tensor-parallel", "2"]
FSDP_3D_FLAGS = ["--fsdp", "2", "--tensor-parallel", "2", "--n-layers", "2"]
FSDP_3D_STEPS = 6
FSDP_TIMEOUT_S = 600


def mlp_bytes(model, opt_state, kfac_state):
    """Bytes this process holds of the MLP weights (every block's ff1 and
    ff2 weight and bias), of their momentum, and of the shard layers' G/A
    stacks a tensor axis splits (ff1's ``G``/``cQG``/``cdG``, ff2's
    ``A``/``rQA``/``rdA``): the tensors' storage on the card, which
    ``torch.cuda.memory_allocated`` counts (up to its 512-byte rounding)."""
    from kfac_pytorch_tpu_torch import capture
    from kfac_pytorch_tpu_torch.shardwise import TENSOR_SPLIT_KEYS

    mlp = [n for n, _ in model.named_parameters() if ".ff1." in n or ".ff2." in n]
    params = dict(model.named_parameters())
    stacks = 0
    for key in ("factors", "eigen"):
        for name, entry in kfac_state[key].items():
            form = capture.split_shard_name(name)[1]
            stacks += sum(v.numel() * v.element_size() for k, v in entry.items()
                          if form and k in TENSOR_SPLIT_KEYS[form])
    return {"weights": sum(params[n].numel() * params[n].element_size() for n in mlp),
            "momentum": sum(opt_state[n].numel() * opt_state[n].element_size() for n in mlp),
            "stacks": stacks}


def fsdp_world1_phase(device, counters, lm_hist):
    """Phase 26a: the LM twin with ``--fsdp 1 --tensor-parallel 1`` (the
    3-D world of one rank) on NCCL at world size 1, phase 8's 38 steps:
    every loss bitwise phase 8's, kernels 2-7 as implied."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    (hist, launches), backend, world = in_nccl_world1(lambda: counted(
        lambda: train_lm(["--epochs", str(LM_EPOCHS), "--fsdp", "1", "--tensor-parallel", "1"]),
        counters))
    model = trainer.build(trainer.parse_args(LM_ARGS), device)[0]
    expected = {LM_COUNTERS[k]: n for k, n in lm_expected_launches(hist, model).items()}
    del model
    torch.cuda.empty_cache()
    gate_launches(launches, expected, "--fsdp 1 --tensor-parallel 1, NCCL world 1")
    if hist["loss"] != lm_hist["loss"]:
        raise AssertionError(f"--fsdp 1 --tensor-parallel 1 at NCCL world 1: losses "
                             f"{hist['loss']} are not phase 8's {lm_hist['loss']}")
    print(f"--fsdp 1 --tensor-parallel 1 at NCCL world 1: {len(hist['loss'])} of "
          f"{len(lm_hist['loss'])} losses bitwise phase 8's; kernels 2-7 as implied", flush=True)
    return {"backend": backend, "world": world, "steps": len(hist["loss"]),
            "losses_bitwise_phase8": True, "launches": launches, "expected_launches": expected}


def fsdp_worker(rank, store, out_path, steps, device_name, argv, world_size):
    """One rank of phases 26b-c (:func:`lm_rank`): :func:`twin_rank_steps`
    with ``argv`` on the data×fsdp×tensor world; the world's layout, the
    kernels' implied launches, the K-FAC stacks' shapes, the MLP bytes
    held and the fsdp parts' sizes; then, after a barrier, on rank 0 of a
    world with an fsdp axis, kernel 4 on this rank's SGD leaves
    (:func:`sgd_phase`)."""

    def body(device):
        import torch

        from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer
        from kfac_pytorch_tpu_torch.models.layers import KFACDense
        from kfac_pytorch_tpu_torch.parallel.mesh import (
            data_fsdp_tensor_world,
            data_parallel_world,
        )

        args = trainer.parse_args(argv)
        trainer.check_world(args, data_parallel_world())
        world = data_fsdp_tensor_world(args.fsdp, args.tensor_parallel)
        rec, (model, kfac, state, _, _) = twin_rank_steps(args, world, device, steps)
        layers = len(model.blocks)
        groups = len({(m.out_features // m.lens_splits, m.in_features + 1)
                      for m in model.modules() if isinstance(m, KFACDense)})
        captures = sum(k != "plain" for k in rec["kinds"])
        facs = state.kfac_state["factors"]
        out = {
            **rec,
            "layout": [world.rank, world.size, world.tensor_rank, world.fsdp_rank],
            "expected_launches": {
                "compute_a_embed_fused": captures, "fused_precondition_stack": groups * steps,
                "fused_sgd_apply": steps, "flash_forward": layers * steps,
                "flash_backward_dq": layers * steps, "flash_backward_dkv": layers * steps},
            "stack_shapes": {"ff1_G": list(facs["blocks.0.ff1#c2"]["G"].shape),
                             "ff2_A": list(facs["blocks.0.ff2#r2"]["A"].shape)},
            "mlp_bytes": mlp_bytes(model, state.opt_state, state.kfac_state),
            "fsdp_parts": {}, "sgd": None,
        }
        fsdp = state.fsdp
        if fsdp is not None:
            out["fsdp_parts"] = {n: [fsdp.parts[n].numel(), state.opt_state[n].numel(),
                                     math.prod(fsdp.shapes[n])] for n in fsdp.params}
        torch.distributed.barrier()  # every rank's steps are done
        if fsdp is not None and rank == 0 and device.type == "cuda":
            leaves, _ = fsdp.sgd_view(dict(model.named_parameters()), {})
            flush = torch.empty(32 << 20, dtype=torch.float32, device=device)
            out["sgd"] = sgd_phase([t.detach() for t in leaves.values()], device, args.base_lr,
                                   args.momentum, args.wd, flush)
            out["sgd"]["unit"] = (f"one SGD step over rank 0's {len(leaves)} leaves of the "
                                  f"--fsdp 2 --tensor-parallel 2 LM: " + out["sgd"]["unit"])
        return out

    lm_rank(rank, store, out_path, device_name, body, world_size)


def fsdp_ranks(device, argv, steps, nprocs):
    """Phase 26c's ranks (:func:`fsdp_worker`): their results."""
    return spawn_ranks(fsdp_worker, (steps, str(device), list(argv), nprocs), FSDP_TIMEOUT_S,
                       "fsdp", nprocs=nprocs)


def fsdp_gate_ranks(ranks, layout, one, steps, path):
    """Kernels 2-7 per rank as implied, each rank's place in the world
    (``layout(global rank)``), and every rank's losses within ``TP_RTOL``
    of rank 0's and of one process (``one``): the worst difference."""
    for r in ranks:
        if r["layout"] != layout(r["rank"]):
            raise AssertionError(f"{path}, rank {r['rank']}: layout {r['layout']}, want "
                                 f"{layout(r['rank'])}")
        gate_launches(r["launches"], r["expected_launches"], f"{path} rank {r['rank']}")
        if r["stack_shapes"]["ff1_G"][0] != 1 or r["stack_shapes"]["ff2_A"][0] != 1:
            raise AssertionError(f"{path}, rank {r['rank']}: stacks {r['stack_shapes']}, want "
                                 "one block each")
    worst = 0.0
    for r in ranks[1:]:
        worst = max(worst, gate_oracle(r["losses"], ranks[0]["losses"],
                                       f"{path}, rank {r['rank']} vs rank 0", range(steps),
                                       rtol=TP_RTOL))
    return worst, gate_oracle(ranks[0]["losses"], one, f"{path} vs one process", range(steps),
                              rtol=TP_RTOL)


def fsdp_tp_phase(ranks, tp_lens, argv):
    """Phase 26b: ``--fsdp 1 --tensor-parallel 2`` on two ranks (data 1 ×
    fsdp 1 × tensor 2): :func:`fsdp_gate_ranks` against 25b's one-process
    lens model over the same 12 steps; each rank's MLP bytes beside 25b's."""
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    args = trainer.parse_args(argv)
    steps = len(tp_lens["losses"])
    peers, worst = fsdp_gate_ranks(ranks, lambda g: [0, 1, g, 0], tp_lens["losses"], steps,
                                   "--fsdp 1 --tensor-parallel 2")
    one = tp_lens["mlp_bytes"]
    ratios = [{k: r["mlp_bytes"][k] / one[k] for k in one} for r in ranks]
    for r, ratio in zip(ranks, ratios):
        if not all(0.45 <= v <= 0.55 for v in ratio.values()):
            raise AssertionError(f"--fsdp 1 --tensor-parallel 2, rank {r['rank']}: MLP bytes "
                                 f"{r['mlp_bytes']} against one process's {one}")
    stats = step_stats({"step_ms": ranks[0]["step_ms"], "kind": ranks[0]["kinds"]},
                       args.batch_size * args.seq_len)
    print(f"--fsdp 1 --tensor-parallel 2 (two ranks, gloo): kernels 2-7 as implied; ff1 G and "
          f"ff2 A {ranks[0]['stack_shapes']['ff1_G']} per rank; losses within {peers:.2e} of each other and "
          f"{worst:.2e} of 25b's one process; MLP weights/momentum/stacks per rank "
          f"{ratios[0]['weights']:.3f}/{ratios[0]['momentum']:.3f}/{ratios[0]['stacks']:.3f} of "
          f"one process's; capture step {stats.get('capture_ms_median', float('nan')):.1f} ms, "
          f"refresh {stats.get('refresh_ms_median', float('nan')):.1f} ms", flush=True)
    return {"ranks": ranks, "steps": steps, "one_process_losses": tp_lens["losses"],
            "max_rel_diff_between_ranks": peers, "max_rel_diff_vs_one_process": worst,
            "one_process_mlp_bytes": one, "mlp_bytes_ratio_per_rank": ratios,
            "capture_step_ms_median": stats.get("capture_ms_median"),
            "refresh_step_ms_median": stats.get("refresh_ms_median")}


def int8_3d_wire_bytes(facs, max_bucket_elems, t=2):
    """The int8 factor wire per rank and flush on a world of ``t`` tensor
    slots, from the one-process lens model's factor tree ``facs`` (its
    tensor-split stacks whole): the wire bytes and the error-feedback
    residual bytes when each slot quantizes only its own blocks of the
    split stacks, and when it quantizes the tree gathered over the slots
    (the port's flush, which keeps the replicated factors equal on every
    slot), with the float32 bytes that tensor gather receives."""
    from kfac_pytorch_tpu_torch import capture
    from kfac_pytorch_tpu_torch.parallel.assignment import plan_factor_buckets
    from kfac_pytorch_tpu_torch.parallel.comm import quant_wire_bytes
    from kfac_pytorch_tpu_torch.shardwise import lenses

    whole, own, gathered = [], [], 0
    for name, entry in facs.items():
        for key, leaf in entry.items():
            shape = tuple(leaf.shape)
            whole.append(shape)
            if lenses.factor_leaf_spec(name, key, (capture.split_shard_name(name)[2],), t):
                own.append((shape[0] // t, *shape[1:]))
                gathered += (t - 1) * leaf.numel() // t * 4
            else:
                own.append(shape)
    out = {}
    for label, shapes in (("own_blocks", own), ("gathered_tree", whole)):
        sizes = [b.size for b in plan_factor_buckets(shapes, max_bucket_elems)]
        out[label] = {"wire_bytes": quant_wire_bytes(sizes), "residual_bytes": 4 * sum(sizes)}
    out["gathered_tree"]["tensor_gather_bytes_received"] = gathered
    return out


def fsdp_one_process(device, steps=FSDP_3D_STEPS):
    """Phase 26c's reference: the lens model (``tensor_parallel=2``) with
    26c's depth on one process at its global batch of 8, the same steps
    through the refresh cadence; its losses, and :func:`int8_3d_wire_bytes`
    of its factors."""
    import torch

    from kfac_pytorch_tpu_torch import EigenRefreshCadence

    step_fn, state, kfac, batches, args = tp_setup(device, ["--n-layers", "2",
                                                            "--batch-size", "8"])
    cadence, losses = EigenRefreshCadence(kfac), []
    for i in range(steps):
        state, m = step_fn(state, batches[i], args.base_lr, kfac.hparams.damping,
                           **cadence.flags_for_step(i, 0))
        losses.append(float(m["loss"]))
    wire = int8_3d_wire_bytes(state.kfac_state["factors"], kfac.factor_comm.max_bucket_elems)
    del step_fn, state, kfac, batches
    torch.cuda.empty_cache()
    return losses, wire


def fsdp_3d_phase(ranks, one, argv, steps=FSDP_3D_STEPS):
    """Phase 26c: ``--fsdp 2 --tensor-parallel 2`` on four ranks (data 1 ×
    fsdp 2 × tensor 2): :func:`fsdp_gate_ranks` against one process at the
    global batch; every fsdp part (and its momentum) half of its
    parameter; rank 0's kernel-4 row on its SGD leaves."""
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    args = trainer.parse_args(argv)
    peers, worst = fsdp_gate_ranks(ranks, lambda g: [g // 2, 2, g % 2, g // 2], one, steps,
                                   "--fsdp 2 --tensor-parallel 2")
    for r in ranks:
        parts = r["fsdp_parts"]
        if not parts or any(2 * p != n or 2 * m != n for p, m, n in parts.values()):
            raise AssertionError(f"--fsdp 2, rank {r['rank']}: fsdp parts {parts}")
    sgd = ranks[0]["sgd"]
    sgd["launches"] = ranks[0]["launches"]["fused_sgd_apply"]
    sgd["launches_per_rank"] = [r["launches"]["fused_sgd_apply"] for r in ranks]
    sgd["launches_per_step"] = sgd["launches"] / steps
    stats = step_stats({"step_ms": ranks[0]["step_ms"], "kind": ranks[0]["kinds"]},
                       args.batch_size * args.seq_len)
    print(f"--fsdp 2 --tensor-parallel 2 (four ranks, gloo): kernels 2-7 as implied; "
          f"{len(ranks[0]['fsdp_parts'])} parameters in fsdp halves; losses within {peers:.2e} "
          f"of each other and {worst:.2e} of one process at the global batch; kernel 4 on rank "
          f"0's leaves bitwise its plain version, {sgd['ms']:.4f} ms (plain {sgd['plain_ms']:.4f}, "
          f"SGD foreach {sgd['library_ms']:.4f}, bound {sgd['bound_ms']:.4f}); capture step "
          f"{stats.get('capture_ms_median', float('nan')):.1f} ms", flush=True)
    return {"ranks": ranks, "steps": steps, "one_process_losses": one,
            "max_rel_diff_between_ranks": peers, "max_rel_diff_vs_one_process": worst,
            "capture_step_ms_median": stats.get("capture_ms_median"),
            "step0_ms": ranks[0]["step_ms"][0]}, sgd


# Phase 27: the telemetry registry, the profiler hook and the planner on
# the ResNet-32 and LM paths, and the rank-aware summary on two ranks.
TELEMETRY_STEPS = 12
TELEMETRY_RANK_STEPS = 6
TELEMETRY_COUNTED = ("compute_a_conv_fused", "fused_precondition_stack", "fused_sgd_apply")
# each counted wrapper's device kernel (name fragment) and its launches per
# wrapper call: kernel 1 one (its partial-sum reduce is another kernel),
# kernel 3 the four of one shape group's chain, kernel 4 one
TRACE_KERNELS = {"compute_a_conv_fused": ("patch_cov_mma", 1),
                 "fused_precondition_stack": ("chain_mma", 4),
                 "fused_sgd_apply": ("fused_sgd", 1)}


def registered_metric_names():
    """The names docs/OBSERVABILITY.md's metric registry lists."""
    with open("docs/OBSERVABILITY.md") as fh:
        text = fh.read()
    body = re.search(r"<!-- metric-registry:start -->(.*?)<!-- metric-registry:end -->",
                     text, re.S).group(1)
    rows = (re.match(r"^\|\s*`([^`]+)`\s*\|", ln.strip()) for ln in body.splitlines())
    return {m.group(1) for m in rows if m}


def check_telemetry_files(tel_dir):
    """``metrics.prom`` and ``telemetry.jsonl`` exist and name only
    registered metrics (a name of a ``<...>`` family, such as
    ``compile/cache_size/<fn>``, counts as its family); returns the names."""
    from kfac_pytorch_tpu_torch.observability.export import prom_name

    registered = registered_metric_names()
    heads = {n[:n.index("<")]: n for n in registered if n.endswith(">")}

    def family(name):
        head = next((h for h in heads if name.startswith(h) and "/" not in name[len(h):]), None)
        return heads[head] if head is not None else name

    names = set()
    with open(f"{tel_dir}/telemetry.jsonl") as fh:
        for line in fh:
            tag = json.loads(line)["tag"]
            kind, rest = tag.split("/", 1)
            names.add(family(rest.rsplit("/", 1)[0] if kind == "span" else rest))
    if not names or not names <= registered:
        raise AssertionError(f"telemetry.jsonl names outside the registry: "
                             f"{sorted(names - registered)}")
    prom = {prom_name(n) for n in registered}
    prom_heads = tuple(prom_name(h) for h in heads)
    with open(f"{tel_dir}/metrics.prom") as fh:
        families = [ln.split()[2] for ln in fh if ln.startswith("# TYPE")]
    stray = [f for f in families
             if f.removesuffix("_seconds") not in prom and not f.startswith(prom_heads)]
    if not families or stray:
        raise AssertionError(f"metrics.prom families outside the registry: {stray}")
    return sorted(names)


def trace_kernel_counts(path):
    """``({counter: device launches}, kernel events, guarded)`` of a Chrome
    trace: the counted kernels' launches and the number of kernel events,
    both without :func:`spin_guard`'s spins, and whether the trace holds
    both guards (its first and last kernel events are spins)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sorted((e["ts"], e["name"]) for e in events if e.get("cat") == "kernel")
    names = [n for _, n in kernels if "spin_kernel" not in n]
    guarded = bool(kernels) and all("spin_kernel" in kernels[i][1] for i in (0, -1))
    return ({key: sum(frag in n for n in names) for key, (frag, _) in TRACE_KERNELS.items()},
            len(names), guarded)


def guarded_trace(maybe_trace):
    """``profiling.maybe_trace`` with a :func:`spin_guard` just inside each
    edge of the traced region: the profiler drops device events at a
    region's edges (``--profile-edges``), and a trace that keeps both
    guards kept everything between them."""
    import torch

    @contextlib.contextmanager
    def traced(log_dir, enabled, device=None):
        on = bool(enabled and log_dir)
        with maybe_trace(log_dir, enabled, device):
            if on:
                spin_guard()
                torch.cuda.synchronize(device)
            yield
            if on:
                torch.cuda.synchronize(device)
                spin_guard()
    return traced


def profiled_train(argv, counters, trace_path, guard):
    """``((history, launches), trace counts, kernel events, guarded)`` of
    one ``train(argv)`` whose ``--profile-epoch`` goes through
    ``profiling.maybe_trace``, between spin guards when ``guard``."""
    from kfac_pytorch_tpu_torch.training import profiling

    plain = profiling.maybe_trace
    if guard:
        profiling.maybe_trace = guarded_trace(plain)
    try:
        out = counted(lambda: train(argv), counters)
    finally:
        profiling.maybe_trace = plain
    return (out, *trace_kernel_counts(trace_path))


def profile_edges(reps, variants, counters):
    """``--profile-edges``: ``reps`` rounds, each profiling the 27a epoch
    once per variant (``plain``: ``profiling.maybe_trace`` as the trainers
    call it; ``guarded``: as 27a calls it, :func:`guarded_trace`), all in
    this process; one JSON line per trace: the counted launches the trace
    lost (counters × device launches per call − trace), its kernel events
    and whether it kept both guards."""
    import torch

    from kfac_pytorch_tpu_torch.training import profiling

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    argv = ["--steps-per-epoch", str(TELEMETRY_STEPS)]
    train(argv)
    for rep in range(reps):
        for variant in variants:
            with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_edges_") as tmp:
                (_, launches), counts, n, guarded = profiled_train(
                    [*argv, "--log-dir", tmp, "--profile-epoch", "0"], counters,
                    f"{tmp}/{profiling.TRACE_FILE}", variant == "guarded")
            lost = {k: TRACE_KERNELS[k][1] * launches[k] - c for k, c in counts.items()}
            print(json.dumps({"profile_edges": {"rep": rep, "variant": variant, "lost": lost,
                                                "kernel_events": n, "guarded": guarded}}),
                  flush=True)


def refresh_excess_ms(hist):
    """The refresh milliseconds of a run's one refresh interval after step
    0 (step 0 pays first-call set-up): its refresh, chunk and swap steps'
    excess over the capture-step median; ``None`` without such a step."""
    ms, kinds = hist["step_ms"][1:], hist["kind"][1:]
    capture = [m for m, k in zip(ms, kinds) if k == "capture"]
    eigen = [m for m, k in zip(ms, kinds) if k in ("refresh", "chunk", "chunk-swap", "swap")]
    if not capture or not eigen:
        return None
    return sum(m - statistics.median(capture) for m in eigen)


def dense_refresh_ms(hist):
    """The mean excess of a monolithic-refresh run's refresh steps (after
    step 0) over its capture-step median: the dense refresh's time."""
    ms, kinds = hist["step_ms"][1:], hist["kind"][1:]
    capture = statistics.median(m for m, k in zip(ms, kinds) if k == "capture")
    return statistics.mean(m - capture for m, k in zip(ms, kinds) if k == "refresh")


def telemetry_phase(device, counters):
    """27a (see the module docstring). The three runs take deterministic
    cuDNN: its default algorithms differ from run to run in the last bits."""
    import torch

    from kfac_pytorch_tpu_torch.training import profiling

    argv = ["--steps-per-epoch", str(TELEMETRY_STEPS)]
    cudnn_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_telemetry_") as tmp:
        # in turns: plain, telemetry, profiled, plain again (the host
        # clock's spread between the two plain runs bounds the overhead)
        runs = {
            "off": counted(lambda: train(argv), counters),
            "telemetry": counted(lambda: train([*argv, "--telemetry-dir", f"{tmp}/tel",
                                                "--profile", "safe"]), counters),
        }
        # the trainer's trace between spin guards, again while the profiler
        # dropped a guard (and with it maybe the region's edge events)
        for _ in range(PROFILE_ATTEMPTS):
            runs["profiled"], trace_counts, trace_kernels, guarded = profiled_train(
                [*argv, "--telemetry-dir", f"{tmp}/tel_prof", "--profile", "safe",
                 "--log-dir", f"{tmp}/log", "--profile-epoch", "0"], counters,
                f"{tmp}/log/{profiling.TRACE_FILE}", guard=True)
            if guarded:
                break
        else:
            raise AssertionError(f"27a: torch.profiler lost an edge guard of the profiled "
                                 f"epoch {PROFILE_ATTEMPTS} times")
        runs["off_again"] = counted(lambda: train(argv), counters)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
        off, off_launches = runs["off"]
        for name, (hist, launches) in runs.items():
            if hist["loss"] != off["loss"]:
                raise AssertionError(f"27a: the {name} run's losses differ from the plain run's")
            if launches != off_launches:
                raise AssertionError(f"27a: the {name} run's launches {launches} differ from "
                                     f"the plain run's {off_launches}")
            if any(launches[k] <= 0 for k in TELEMETRY_COUNTED):
                raise AssertionError(f"27a: a counted kernel did not launch: {launches}")
        names = check_telemetry_files(f"{tmp}/tel")
        check_telemetry_files(f"{tmp}/tel_prof")
        prof_launches = runs["profiled"][1]
        for key, n in trace_counts.items():
            frag, per_call = TRACE_KERNELS[key]
            if n != per_call * prof_launches[key]:
                raise AssertionError(f"27a: the profiler trace holds {n} {frag} launches, the "
                                     f"counter {prof_launches[key]} calls of {per_call}")
    tel_hist = runs["telemetry"][0]
    spans = tel_hist["telemetry"]["spans"]
    stats = {name: step_stats(hist, BATCH) for name, (hist, _) in runs.items()}
    out = {
        "steps": TELEMETRY_STEPS,
        "losses_bitwise_equal": True,
        "launches": off_launches,
        "registered_names_written": len(names),
        "step_factors_span_p50_ms": spans["step/factors"]["p50"] * 1e3,
        "step_eigen_span_p50_ms": spans["step/eigen"]["p50"] * 1e3,
        "step_eigen_span_count": spans["step/eigen"]["count"],
        "host_capture_step_ms_median": stats["telemetry"]["capture_ms_median"],
        "host_refresh_step_ms_median": stats["telemetry"]["refresh_ms_median"],
        "capture_step_ms_median_off": stats["off"]["capture_ms_median"],
        "capture_step_ms_median_telemetry": stats["telemetry"]["capture_ms_median"],
        "capture_step_ms_median_profiled": stats["profiled"]["capture_ms_median"],
        "capture_step_ms_median_off_again": stats["off_again"]["capture_ms_median"],
        "telemetry_capture_overhead_ms": stats["telemetry"]["capture_ms_median"] - statistics.mean(
            (stats["off"]["capture_ms_median"], stats["off_again"]["capture_ms_median"])),
        "plain_runs_capture_spread_ms": abs(stats["off"]["capture_ms_median"]
                                            - stats["off_again"]["capture_ms_median"]),
        "trace_kernel_launches": trace_counts,
        "trace_kernel_events": trace_kernels,
        "spans_p50_ms": {n: s["p50"] * 1e3 for n, s in sorted(spans.items())},
        "spans_count": {n: s["count"] for n, s in sorted(spans.items())},
    }
    return out, dense_refresh_ms(off)


def planner_run(device, counters, path, calib_refresh_ms):
    """27b on one path (``"resnet"`` or ``"lm"``): the production profile
    with autotune through the twin, its plan, candidates and winner; then
    the resolved plan itself (no autotune) and the drift of its refresh
    against the cost model's prediction."""
    import torch

    from kfac_pytorch_tpu_torch import planner
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm_trainer
    from kfac_pytorch_tpu_torch.models import cifar_resnet
    from kfac_pytorch_tpu_torch.observability.telemetry import Telemetry

    extra = ["--steps-per-epoch", str(TELEMETRY_STEPS), "--profile", "production"]
    if path == "resnet":
        run = train
        model = cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0))
    else:
        # a re-orthonormalization at every boundary (an explicit lever wins
        # over the plan): the truncated refresh is measured at step 10
        def run(argv):
            return train_lm(["--epochs", "1", "--stream-drift-threshold", "0", *argv])

        model = lm_trainer.build(lm_trainer.parse_args([*LM_ARGS, "--device", "cpu"]),
                                 torch.device("cpu"))[0]
    tuned, launches = counted(lambda: run([*extra, "--autotune-steps", "2"]), counters)
    hist = run(extra)
    for h in (tuned, hist):
        if not all(math.isfinite(v) for v in h["loss"]):
            raise AssertionError(f"27b {path}: non-finite loss {h['loss']}")
    record = tuned["plan"]
    if "autotune" not in record:
        raise AssertionError(f"27b {path}: the production plan gave autotune one candidate")
    facts = planner.model_facts(model)
    plan = planner.Plan.from_dict(hist["plan"]["plan"])
    resolved = planner.Plan.from_dict(record["autotune"]["candidates"][0])
    if plan != resolved:
        raise AssertionError(f"27b {path}: without autotune the run took {plan.describe()}, "
                             f"not the resolved {resolved.describe()}")
    measured = refresh_excess_ms(hist)
    dense_macs = planner.cost_model.refresh_cost(facts, planner.Plan())
    tel = Telemetry(enabled=True)
    drift = planner.detect_drift(
        facts, plan, measured_refresh_ms=measured,
        calibration_macs_per_ms=dense_macs / calib_refresh_ms if calib_refresh_ms else None,
        telemetry=tel)
    return {
        "resolved_plan": resolved.describe(),
        "dropped": record["dropped"],
        "autotune_candidates": [planner.Plan.from_dict(c).describe()
                                for c in record["autotune"]["candidates"]],
        "autotune_ms": [t * 1e3 for t in record["autotune"]["seconds"]],
        "autotune_winner": record["autotune"]["winner_index"],
        "autotuned_run_plan": planner.Plan.from_dict(record["plan"]).describe(),
        "launches": launches,
        "kinds": hist["kind"],
        "step_ms": hist["step_ms"],
        "refresh_cost_macs": {"dense": dense_macs,
                              "run_plan": planner.cost_model.refresh_cost(facts, plan),
                              "resolved": planner.cost_model.refresh_cost(facts, resolved)},
        "calibration_dense_refresh_ms": calib_refresh_ms,
        "measured_refresh_ms": measured,
        "drift": drift.to_dict(),
        "drift_gauges": {k: v for k, v in tel.snapshot()["gauges"].items()},
    }


def telemetry_rank_worker(rank, store, out_path, steps, device_name):
    """One rank of phase 27c (``torch.multiprocessing`` target): the CIFAR
    twin with ``--telemetry-dir`` over gloo on ``cuda:0``, then the
    rank-aware summary table again (a collective), this rank's own span
    counts and gauges, and the cost model's f32 wire bytes of the model."""
    import torch

    from kfac_pytorch_tpu_torch import planner
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.models import cifar_resnet
    from kfac_pytorch_tpu_torch.observability import get_telemetry, summary_table
    from kfac_pytorch_tpu_torch.parallel import launch

    launch.initialize(device_name, backend="gloo", init_method=f"file://{store}",
                      rank=rank, world_size=2)
    try:
        hist = trainer.main([*RESNET_ARGS, *SHORT_CADENCE, "--steps-per-epoch", str(steps),
                             "--telemetry-dir", f"{out_path}-tel{rank}"])
        tel = get_telemetry()
        model = cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0))
        gauges = hist["telemetry"]["gauges"]
        drift = planner.detect_drift(
            planner.model_facts(model), planner.Plan(),
            measured_wire_bytes_f32=int(gauges["kfac/factor_wire_bytes"]), telemetry=tel)
        out = {"losses": hist["loss"], "table": summary_table(tel),
               "own_counts": {n: len(h) for n, h in tel.hists.items()},
               "gauges": gauges, "wire_drift": drift.to_dict()}
        with open(f"{out_path}-{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        torch.distributed.destroy_process_group()


def telemetry_ranks_phase(ranks):
    """27c (see the module docstring): ``ranks``, :func:`telemetry_rank_worker`'s
    two ranks' results."""
    steps = TELEMETRY_RANK_STEPS
    tables = [r["table"] for r in ranks]
    if tables[0] != tables[1]:
        raise AssertionError("27c: the two ranks built different summary tables")
    merged = {}
    for line in tables[0].splitlines()[1:]:
        parts = line.split()
        if parts[0] != "counter":
            merged[parts[0]] = int(parts[1])
    want = {n: ranks[0]["own_counts"].get(n, 0) + ranks[1]["own_counts"].get(n, 0)
            for n in set(ranks[0]["own_counts"]) | set(ranks[1]["own_counts"])}
    if merged != want:
        raise AssertionError(f"27c: the merged table counts {merged}, the ranks' sum {want}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError("27c: the ranks' losses differ")
    return {"steps": steps, "summary_table": tables[0], "merged_span_counts": merged,
            "wire_drift": ranks[0]["wire_drift"],
            "factor_collectives": ranks[0]["gauges"]["kfac/factor_collectives"]}


# The elastic runtime (phase 28): ResNet-32 through the CIFAR twin on the
# written CIFAR-format set, 2 epochs of 8 steps, refreshes every 4 steps
# pipelined over 3 chunks, a snapshot every 4 steps; killed at step 6.
ELASTIC_CIFAR_FLAGS = ["--epochs", "2", "--steps-per-epoch", "8", "--kfac-update-freq", "4",
                       "--eigh-chunks", "3"]
ELASTIC_CIFAR_EVERY = 4
ELASTIC_CIFAR_KILL = 6
# the LM at phase 8's widths, 12 steps (refreshes at 0 and 10), a snapshot
# every 5 steps, killed at step 7; the overhead ratio at one snapshot per
# ELASTIC_OVERHEAD_N steps
ELASTIC_LM_FLAGS = ["--epochs", "1", "--steps-per-epoch", "12"]
ELASTIC_LM_EVERY = 5
ELASTIC_LM_KILL = 7
ELASTIC_OVERHEAD_N = 10
# the WikiText LSTM at small widths (200, the recipe's dropout 0.5), 2
# epochs of 6 steps, killed mid-epoch at step 4
ELASTIC_LSTM_FLAGS = ["--emsize", "200", "--nhid", "200", "--epochs", "2", "--steps-per-epoch",
                      "6", "--kfac-update-freq", "4"]
ELASTIC_LSTM_KILL = 4
# two ranks: owner-sharded ResNet-32 with the deferred flush every 3
# capture steps, refreshes every 4, 12 steps; killed at step 6 (step 5 is
# a capture after the step-4 flush: factor_sync_age 1), resumed on two
# ranks and, through the 2 -> 1 resize, on one process, whose parameters
# at step 12 must be within ELASTIC_RESIZE_TOL of the replicated
# continuation of the state the resize resumed
ELASTIC_RANK_FLAGS = [*SHORT_CADENCE, "--epochs", "1", "--steps-per-epoch", "12"]
ELASTIC_OWNER_FLAGS = ["--factor-sharding", "owner", "--factor-comm-freq", "3"]
ELASTIC_RANK_STEPS = 12
ELASTIC_RANK_KILL = 6
ELASTIC_RESIZE_TOL = 1e-6
ELASTIC_COUNTED = ("compute_a_conv_fused", "fused_precondition_stack", "fused_sgd_apply")


@contextlib.contextmanager
def fault_env(at=None, mode="signal"):
    """The fault injector's ``KFAC_FAULT_*`` variables for the block (none
    when ``at`` is None); the SIGTERM handler the twin installs is put back
    after it."""
    import os
    import signal

    keys = ("KFAC_FAULT_KILL_AT_STEP", "KFAC_FAULT_KILL_MODE")
    old_env = {k: os.environ.pop(k, None) for k in keys}
    old_handler = signal.getsignal(signal.SIGTERM)
    if at is not None:
        os.environ.update({keys[0]: str(at), keys[1]: mode})
    try:
        yield
    finally:
        for k, v in old_env.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        signal.signal(signal.SIGTERM, old_handler)


def elastic_flags(save_dir, every):
    return ["--preempt-save-dir", save_dir, "--snapshot-every", str(every)]


def latest_step(save_dir):
    from kfac_pytorch_tpu_torch.elastic import state_io

    found = state_io.latest_snapshot(save_dir)
    return None if found is None else found[0]


def gate_resumed(full, resumed, at, path):
    """The resumed run's losses are the uninterrupted run's from ``at``,
    bit for bit, and it restored once."""
    if resumed["loss"] != full["loss"][at:]:
        raise AssertionError(f"{path}: the run resumed at step {at} trained {resumed['loss']}, "
                             f"the uninterrupted run {full['loss'][at:]}")
    if len(resumed["restore_ms"]) != 1:
        raise AssertionError(f"{path}: {len(resumed['restore_ms'])} restores")


_KILLED_CHILD = """
import json, sys
import torch
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
from kfac_pytorch_tpu_torch.elastic import faults
from kfac_pytorch_tpu_torch.examples import {trainer} as trainer
from kfac_pytorch_tpu_torch.ops import apply_kernels as ak, factor_kernels as fk
counters = (fk.compute_a_conv_fused, ak.fused_precondition_stack, ak.fused_sgd_apply)
fire = faults.FaultInjector.on_step
def on_step(self, step, supervisor=None):
    if not self.fired and step >= self.spec.kill_at_step:
        with open({path!r}, "w") as fh:
            json.dump({{fn.__name__: fn.launches for fn in counters}}, fh)
    fire(self, step, supervisor)
faults.FaultInjector.on_step = on_step
trainer.main({argv!r})
"""


def killed_child(trainer, argv, at, tmp):
    """``(exit code, stderr, launches)`` of the twin run in a subprocess
    with ``KFAC_FAULT_KILL_AT_STEP=at`` in exit mode, the launches of
    kernels 1, 3 and 4 read just before the kill."""
    import os

    path = f"{tmp}/killed_launches.json"
    env = dict(os.environ, KFAC_FAULT_KILL_AT_STEP=str(at), KFAC_FAULT_KILL_MODE="exit")
    res = subprocess.run(
        [sys.executable, "-c", _KILLED_CHILD.format(trainer=trainer, argv=list(argv), path=path)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env, capture_output=True, text=True,
        timeout=300)
    launches = None
    if os.path.exists(path):
        with open(path) as fh:
            launches = json.load(fh)
    return res.returncode, res.stderr, launches


def elastic_times(hist):
    """The snapshots' blocking and write milliseconds (medians) of a run."""
    rec = hist["elastic"]
    return {"snapshots": len(rec["snapshot_ms"]),
            "blocking_ms_median": statistics.median(rec["snapshot_ms"]),
            "write_ms_median": statistics.median(rec["write_ms"]),
            "blocking_ms": rec["snapshot_ms"], "write_ms": rec["write_ms"]}


def elastic_cifar_phase(device, counters, data_dir, tmp):
    """28a (see the module docstring): ResNet-32 through the CIFAR twin."""
    import os

    from kfac_pytorch_tpu_torch.elastic import state_io
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    base = cifar_args(data_dir, ELASTIC_CIFAR_FLAGS)
    every, kill = ELASTIC_CIFAR_EVERY, ELASTIC_CIFAR_KILL

    def run(save_dir, at=None):
        with fault_env(at):
            hist, launches = counted(
                lambda: trainer.main([*base, *elastic_flags(f"{tmp}/{save_dir}", every)]),
                counters)
        gate_launches(launches, cifar_expected_launches(hist, device), f"28a {save_dir}")
        return hist, launches

    full, full_launches = run("full")
    rc, err, killed_launches = killed_child("train_cifar10_resnet",
                                            [*base, *elastic_flags(f"{tmp}/exit", every)],
                                            kill, tmp)
    if rc != 75 or f"hard-killing at step {kill}" not in err:
        raise AssertionError(f"28a: the exit-mode kill ended with rc {rc}: {err[-2000:]}")
    if latest_step(f"{tmp}/exit") != every:
        raise AssertionError(f"28a: newest complete snapshot at {latest_step(f'{tmp}/exit')}, "
                             f"want {every}")
    if killed_launches is None:
        raise AssertionError("28a: the killed run wrote no launch counts")
    gate_launches(killed_launches, cifar_expected_launches(
        {"kind": full["kind"][:kill], "loss": full["loss"][:kill]}, device), "28a killed")
    resumed, resumed_launches = run("exit")
    gate_resumed(full, resumed, every, "28a exit mode")
    signalled, _ = run("signal", at=kill)
    if signalled["loss"] != full["loss"][:kill] or latest_step(f"{tmp}/signal") != kill:
        raise AssertionError(f"28a: the signal-mode run stopped after {len(signalled['loss'])} "
                             f"steps, snapshot {latest_step(f'{tmp}/signal')}")
    manifest = state_io.load_manifest(state_io.snapshot_dir(f"{tmp}/signal", kill))
    if manifest["cadence"]["landed"] != [0, 1]:
        raise AssertionError(f"28a: snap-{kill}'s cadence landed {manifest['cadence']['landed']}")
    resumed6, resumed6_launches = run("signal")
    gate_resumed(full, resumed6, kill, "28a signal mode")
    stats = step_stats(full, BATCH)
    out = {
        "steps": len(full["loss"]), "killed_exit_at": kill, "resumed_exit_from": every,
        "killed_signal_at": kill, "resumed_signal_steps": len(resumed6["loss"]),
        "losses_bitwise": True, "cadence_landed_at_kill": manifest["cadence"]["landed"],
        **elastic_times(full),
        "restore_ms": {"exit": resumed["restore_ms"][0], "signal": resumed6["restore_ms"][0]},
        "emergency_snapshot_ms": signalled["elastic"]["snapshot_ms"][-1],
        "payload_bytes": os.path.getsize(os.path.join(
            state_io.snapshot_dir(f"{tmp}/full", 2 * 8), state_io.PAYLOAD_NAME)),
        "capture_step_ms_median": stats["capture_ms_median"],
        "launches": {"uninterrupted": full_launches, "killed": killed_launches,
                     "resumed_exit": resumed_launches, "resumed_signal": resumed6_launches},
    }
    print(f"28a ResNet-32: snapshot blocking {out['blocking_ms_median']:.2f} ms (median of "
          f"{out['snapshots']}), write {out['write_ms_median']:.2f} ms, restore "
          f"{out['restore_ms']['exit']:.2f} ms, capture step {out['capture_step_ms_median']:.2f} "
          f"ms, payload {out['payload_bytes']} B", flush=True)
    return out


def elastic_lstm_phase(device, counters, tmp):
    """28a, the WikiText LSTM: killed mid-epoch at dropout 0.5, resumed
    bitwise (the dropout generator and the recurrent carry ride the
    snapshot)."""
    from kfac_pytorch_tpu_torch.examples import train_wikitext_rnn as trainer

    kill = ELASTIC_LSTM_KILL

    def run(save_dir, at=None):
        with fault_env(at):
            hist, launches = counted(lambda: trainer.main(
                [*WIKITEXT_ARGS, *ELASTIC_LSTM_FLAGS, *elastic_flags(f"{tmp}/{save_dir}", 2)]),
                counters)
        gate_launches(launches, wikitext_expected(hist), f"28a LSTM {save_dir}")
        return hist, launches

    full, full_launches = run("lstm_full")
    killed, _ = run("lstm", at=kill)
    if killed["loss"] != full["loss"][:kill] or latest_step(f"{tmp}/lstm") != kill:
        raise AssertionError(f"28a LSTM: the signal-mode run stopped after "
                             f"{len(killed['loss'])} steps")
    resumed, resumed_launches = run("lstm")
    gate_resumed(full, resumed, kill, "28a LSTM")
    print(f"28a LSTM: killed at step {kill} of {len(full['loss'])} (mid-epoch, dropout 0.5), "
          f"resumed bitwise; restore {resumed['restore_ms'][0]:.2f} ms", flush=True)
    return {"steps": len(full["loss"]), "killed_signal_at": kill, "losses_bitwise": True,
            **elastic_times(full), "restore_ms": resumed["restore_ms"][0],
            "launches": {"uninterrupted": full_launches, "resumed": resumed_launches}}


def elastic_lm_phase(device, counters, tmp):
    """28b (see the module docstring): the LM at phase 8's widths."""
    import os

    import torch

    from kfac_pytorch_tpu_torch.elastic import state_io
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as trainer

    every, kill = ELASTIC_LM_EVERY, ELASTIC_LM_KILL
    args = trainer.parse_args(LM_ARGS)
    model = trainer.build(args, device)[0]

    def run(save_dir, at=None):
        with fault_env(at):
            hist, launches = counted(lambda: train_lm(
                [*ELASTIC_LM_FLAGS, *elastic_flags(f"{tmp}/{save_dir}", every)]), counters)
        expected = {LM_COUNTERS[k]: n for k, n in lm_expected_launches(hist, model).items()}
        gate_launches(launches, expected, f"28b {save_dir}")
        return hist, launches

    full, full_launches = run("lm_full")
    killed, _ = run("lm", at=kill)
    if killed["loss"] != full["loss"][:kill] or latest_step(f"{tmp}/lm") != kill:
        raise AssertionError(f"28b: the signal-mode run stopped after {len(killed['loss'])} steps")
    resumed, resumed_launches = run("lm")
    gate_resumed(full, resumed, kill, "28b")
    del model
    torch.cuda.empty_cache()
    stats = step_stats(full, args.batch_size * args.seq_len)
    times = elastic_times(full)
    total = [b + w for b, w in zip(full["elastic"]["snapshot_ms"], full["elastic"]["write_ms"])]
    out = {
        "steps": len(full["loss"]), "killed_signal_at": kill, "losses_bitwise": True, **times,
        "total_ms_median": statistics.median(total),
        "emergency_snapshot_ms": killed["elastic"]["snapshot_ms"][-1],
        "restore_ms": resumed["restore_ms"][0],
        "payload_bytes": os.path.getsize(os.path.join(
            state_io.snapshot_dir(f"{tmp}/lm_full", 2 * every), state_io.PAYLOAD_NAME)),
        "step_ms_mean": stats["mean_ms"],
        "overhead_n": ELASTIC_OVERHEAD_N,
        "overhead_ratio": times["blocking_ms_median"] / (ELASTIC_OVERHEAD_N * stats["mean_ms"]),
        "launches": {"uninterrupted": full_launches, "resumed": resumed_launches},
    }
    print(f"28b LM: payload {out['payload_bytes']} B, snapshot blocking "
          f"{out['blocking_ms_median']:.2f} ms, total {out['total_ms_median']:.2f} ms, restore "
          f"{out['restore_ms']:.2f} ms; mean step {out['step_ms_mean']:.2f} ms: overhead at one "
          f"snapshot per {ELASTIC_OVERHEAD_N} steps {out['overhead_ratio']:.4f}", flush=True)
    return out


def elastic_rank_worker(rank, store, out_path, device_name, runs):
    """One rank of phase 28c (``torch.multiprocessing`` target): the CIFAR
    twin runs ``runs`` (``[(name, argv, kill step or None)]``) in order over
    gloo on ``cuda:0``, deterministic cuDNN; per run the losses, step
    kinds, snapshot times and restores, and the launches of kernels 1, 3
    and 4 beside what the run's steps imply (kernel 3 on the shape groups
    this rank solves)."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
    from kfac_pytorch_tpu_torch.parallel import launch
    from kfac_pytorch_tpu_torch.parallel.mesh import data_parallel_world

    device = launch.initialize(device_name, backend="gloo", init_method=f"file://{store}",
                               rank=rank, world_size=2)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    counters = (fk.compute_a_conv_fused, ak.fused_precondition_stack, ak.fused_sgd_apply)
    try:
        out = {}
        for name, argv, at in runs:
            with fault_env(at):
                hist, launches = counted(lambda: trainer.main(argv), counters)
            model, kfac, _, _ = trainer.build(trainer.parse_args(argv), device,
                                               data_parallel_world())
            expected = conv_expected_launches(hist, model, device)
            if kfac.owner_sharded:
                expected["fused_precondition_stack"] = (owner_apply_groups(kfac, rank)
                                                        * len(hist["loss"]))
            del model, kfac
            out[name] = {"losses": hist["loss"], "kinds": hist["kind"],
                         "elastic": hist.get("elastic"), "restore_ms": hist["restore_ms"],
                         "launches": launches, "expected_launches": {
                             k: v for k, v in expected.items() if k in ELASTIC_COUNTED}}
        with open(f"{out_path}-{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        torch.distributed.destroy_process_group()


def payload_tensors(save_dir, step):
    """``{path: tensor}`` of one snapshot's payload, on the CPU."""
    import torch

    from kfac_pytorch_tpu_torch.elastic import state_io

    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}")
        elif isinstance(tree, torch.Tensor):
            out[path] = tree

    walk(state_io.load_payload(state_io.snapshot_dir(save_dir, step), "cpu"), "")
    return out


def one_snapshot_dir(src, step, dst):
    """A directory holding only ``src``'s ``snap-<step>``: what a restart
    scans when that snapshot is the newest."""
    import os
    import shutil

    from kfac_pytorch_tpu_torch.elastic import state_io

    shutil.copytree(state_io.snapshot_dir(src, step),
                    os.path.join(dst, os.path.basename(state_io.snapshot_dir(src, step))))
    return dst


def resized_state_check(device, argv, snap_parent, step, same_dir):
    """The 2 -> 1 resize through the library: the owner-form snapshot
    resumed by a one-process preconditioner that asked for the owner mode
    (``Supervisor.scan_resume``, the resize replan), every layer's factors
    and bases bitwise its slots' rows of the snapshot's global stacks by
    the two-rank plan; the resized state saved again, in replicated form,
    into ``same_dir`` (what the replicated continuation resumes). Returns
    the tensors compared."""
    from kfac_pytorch_tpu_torch import KFAC
    from kfac_pytorch_tpu_torch.elastic import Supervisor, state_io
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer
    from kfac_pytorch_tpu_torch.parallel.assignment import plan_factor_shards

    model, kfac, state, _ = trainer.build(trainer.parse_args(argv), device)
    cadence = trainer.refresh_cadence(kfac, lambda: state)
    state, manifest, resumed = Supervisor(snap_parent, kfac=kfac,
                                          cadence=cadence).scan_resume(state)
    saved = state_io.load_payload(state_io.snapshot_dir(snap_parent, step), "cpu")["kfac_state"]
    shapes, diag = kfac.factor_shapes(model)
    plan = plan_factor_shards(shapes, manifest["world"], kfac.factor_comm.max_bucket_elems,
                              diag_a=set(diag))
    kstate = state.kfac_state
    full = KFAC._eigen_entries_from_split(kstate["eigen"], kstate["eigen_stacked"], shapes)
    compared = 0
    for s in plan.slots:
        r = s.owner * plan.group_rows[s.size] + s.row
        pairs = [(kstate["factors"][s.name][s.factor], saved["factor_shard"][f"n{s.size}"][r])]
        pairs += [(full[s.name][f"{field}{s.factor}"], t[r])
                  for field, t in saved["eigen_shard"][f"n{s.size}"].items()]
        for got, want in pairs:
            if not bool((got.cpu() == want).all()):
                raise AssertionError(f"28c: the resize did not carry {s.name}'s {s.factor} side "
                                     f"bitwise")
            compared += 1
    state_io.save_snapshot(same_dir, resumed, state, kfac=kfac, cadence=cadence)
    return compared


def elastic_ranks_phase(device, counters, data_dir, tmp):
    """28c (see the module docstring): two ranks of the one card, then one
    process."""
    from kfac_pytorch_tpu_torch.elastic import state_io
    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as trainer

    kill, steps = ELASTIC_RANK_KILL, ELASTIC_RANK_STEPS
    # the owner mode keeps no per-layer spectra for --kfac-diagnostics
    owner = cifar_args(data_dir, [*ELASTIC_RANK_FLAGS, *ELASTIC_OWNER_FLAGS], flags=())
    replicated = cifar_args(data_dir, ELASTIC_RANK_FLAGS, flags=())
    dev = "cuda:0" if device.type == "cuda" else "cpu"
    first = spawn_ranks(elastic_rank_worker, (dev, [
        ("full", [*owner, *elastic_flags(f"{tmp}/r_full", kill)], None),
        ("killed", [*owner, *elastic_flags(f"{tmp}/r_owner", kill)], kill),
    ]), TWO_RANK_TIMEOUT_S, "elastic")
    # what one process resumes: the snapshot alone in a directory
    one_snapshot_dir(f"{tmp}/r_owner", kill, f"{tmp}/w1_owner")
    second = spawn_ranks(elastic_rank_worker, (dev, [
        ("resumed", [*owner, *elastic_flags(f"{tmp}/r_owner", kill)], None),
    ]), TWO_RANK_TIMEOUT_S, "elastic_resume")
    for rank, (a, b) in enumerate(zip(first, second)):
        for name, run in (*a.items(), *b.items()):
            gate_launches(run["launches"], run["expected_launches"], f"28c rank {rank} {name}")
        if a["killed"]["losses"] != a["full"]["losses"][:kill]:
            raise AssertionError(f"28c rank {rank}: the killed run's losses differ")
        gate_resumed({"loss": a["full"]["losses"]},
                     {"loss": b["resumed"]["losses"], "restore_ms": b["resumed"]["restore_ms"]},
                     kill, f"28c rank {rank}")
    manifest = state_io.load_manifest(state_io.snapshot_dir(f"{tmp}/w1_owner", kill))
    mid = payload_tensors(f"{tmp}/w1_owner", kill)
    age = int(mid["/kfac_state/factor_sync_age"])
    if (manifest["sharding"], manifest["world"], manifest.get("packed_world"), age) != (
            "owner", 2, 2, 1):
        raise AssertionError(f"28c: snap-{kill} is {manifest['sharding']} on world "
                             f"{manifest['world']}, packed {manifest.get('packed_world')}, "
                             f"factor_sync_age {age}")
    # each rank's own deferred accumulators: the packed rows differ
    local = [t for k, t in mid.items() if k.startswith("/kfac_state/factor_local/")]
    if not local or all(t.shape[0] != 2 or bool((t[0] == t[1]).all()) for t in local):
        raise AssertionError(f"28c: snap-{kill}'s packed factor_local rows are not two ranks' own")
    # the uninterrupted and the resumed runs' last snapshots: every tensor of
    # both ranks' state (the packed factor_local rows among them)
    want, got = (payload_tensors(f"{tmp}/{d}", steps) for d in ("r_full", "r_owner"))
    if want.keys() != got.keys() or any(not bool((want[k] == got[k]).all()) for k in want):
        raise AssertionError("28c: the resumed ranks' state at step "
                             f"{steps} differs from the uninterrupted ranks'")

    # one process, the owner mode asked for (it runs replicated on one
    # rank): the same snapshot through the 2 -> 1 resize replan, and the
    # replicated continuation of the state it resumes
    def one(save_dir, argv, telemetry=False):
        extra = ["--telemetry-dir", f"{tmp}/{save_dir}_tel"] if telemetry else []
        hist, launches = counted(lambda: trainer.main(
            [*argv, *elastic_flags(f"{tmp}/{save_dir}", steps), *extra]), counters)
        gate_launches(launches, cifar_expected_launches(hist, device), f"28c {save_dir}")
        if not all(math.isfinite(v) for v in hist["loss"]):
            raise AssertionError(f"28c {save_dir}: non-finite loss {hist['loss']}")
        return hist, payload_tensors(f"{tmp}/{save_dir}", steps), launches

    resized, resized_state, resized_launches = one("w1_owner", owner, telemetry=True)
    replans = resized["telemetry"]["gauges"].get("kfac/replan_count")
    if replans != 1:
        raise AssertionError(f"28c: kfac/replan_count reads {replans} after the 2 -> 1 resume")
    # (the resize again, through the library: its state, saved in replicated
    # form, is what the replicated continuation resumes)
    one_snapshot_dir(f"{tmp}/r_owner", kill, f"{tmp}/w1_again")
    carried = resized_state_check(device, owner, f"{tmp}/w1_again", kill, f"{tmp}/w1_same")
    same_hist, same, _ = one("w1_same", replicated)
    keys = [k for k in same if k.startswith("/model/") and same[k].is_floating_point()]
    diff = max(float((resized_state[k] - same[k]).abs().max()) for k in keys)
    excess = max(float(((resized_state[k] - same[k]).abs()
                        - ELASTIC_RESIZE_TOL * same[k].abs()).max()) for k in keys)
    if excess > ELASTIC_RESIZE_TOL or len(same_hist["loss"]) != steps - kill:
        raise AssertionError(f"28c: the 2 -> 1 resize from snap-{kill} is {diff:.3e} from "
                             f"the replicated continuation at step {steps}")
    times = elastic_times({"elastic": first[0]["full"]["elastic"]})
    out = {
        "ranks": 2, "steps": steps, "killed_signal_at": kill, "factor_sync_age_at_kill": age,
        "packed_world": manifest["packed_world"], "resumed_ranks_bitwise": True,
        "state_tensors_compared": len(want), "replan_count": replans,
        "resize_carried_tensors_bitwise": carried, "resize_params_max_abs_diff": diff,
        "resize_tolerance": ELASTIC_RESIZE_TOL,
        "rank_snapshot_blocking_ms_median": times["blocking_ms_median"],
        "rank_snapshot_write_ms_median": times["write_ms_median"],
        "rank_restore_ms": [b["resumed"]["restore_ms"][0] for b in second],
        "one_process_restore_ms": resized["restore_ms"][0],
        "launches_per_rank": {name: [r[name]["launches"] for r in first] for name in first[0]},
        "resumed_launches_per_rank": [b["resumed"]["launches"] for b in second],
        "one_process_launches": {"resized": resized_launches},
    }
    print(f"28c two ranks: resumed bitwise from snap-{kill} (factor_sync_age {age}, packed "
          f"world 2); 2 -> 1 resize: kfac/replan_count {replans}, {carried} factor and basis "
          f"tensors carried bitwise; at step {steps} the parameters are {diff:.3e} from the "
          f"replicated continuation of the same state", flush=True)
    return out


def elastic_phases(device, counters):
    """28a-c, on one written CIFAR-format set, with deterministic cuDNN (its
    default algorithms differ from run to run in the last bits)."""
    import torch

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_elastic_") as tmp:
            data_dir = write_cifar_set(f"{tmp}/data")
            mark("28a. elastic: ResNet-32 and the LSTM, killed and resumed")
            cifar = elastic_cifar_phase(device, counters, data_dir, tmp)
            lstm = elastic_lstm_phase(device, counters, tmp)
            mark("28b. elastic: the LM, killed and resumed")
            lm = elastic_lm_phase(device, counters, tmp)
            mark("28c. elastic: two ranks, the 2 -> 1 resize")
            ranks = elastic_ranks_phase(device, counters, data_dir, tmp)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    return {"resnet32": cifar, "lstm": lstm, "lm": lm, "two_ranks": ranks}


# The curvature service (phase 29): ResNet-32 (batch 128) and the LM at
# phase 8's widths with the refresh moved out of the training step. 29a:
# the in-process layout, the worker a thread refreshing on a CUDA stream of
# its own on the same card; its gate at staleness 0 with the capture every
# second step (so step s + 1 captures nothing and the inline schedule whose
# refresh runs at s + 1 reads exactly the snapshot the worker saw), then the
# step-time distributions of the inline run and the service runs at
# staleness 0 and 1, at the recipe's cadence. 29b: the twins'
# --service-devices 1 on two ranks of the card over gloo, rank 1 the worker.
SERVICE_FREQ = 10
SERVICE_GATE_FAC = 2
SERVICE_RTOL = 1e-6
SERVICE_LM_STEPS = 12
SERVICE_RANK_STEPS = 12
SERVICE_CIFAR_FLAGS = [*SHORT_CADENCE, "--epochs", "1", "--steps-per-epoch",
                       str(SERVICE_RANK_STEPS)]
SERVICE_LM_FLAGS = ["--epochs", "1", "--steps-per-epoch", str(SERVICE_LM_STEPS)]


@contextlib.contextmanager
def eigh_by_thread():
    """``torch.linalg.eigh`` calls (every refresh path ends in it), counted
    by thread: ``{"trainer": n, "worker": n}``, the trainer being the main
    thread."""
    import threading

    import torch

    calls = {"trainer": 0, "worker": 0}
    real = torch.linalg.eigh

    def counted(*args, **kwargs):
        main = threading.current_thread() is threading.main_thread()
        calls["trainer" if main else "worker"] += 1
        return real(*args, **kwargs)

    torch.linalg.eigh = counted
    try:
        yield calls
    finally:
        torch.linalg.eigh = real


def service_steps(setup, steps, budget=None, device=None, inline_at=0, keep_params=False):
    """``steps`` steps of ``setup`` (``(step_fn, state, kfac, batches,
    args)``): with a ``budget``, through an in-process ``CurvatureService``
    whose worker refreshes on ``device``; else with the inline refresh at
    ``step % kfac_update_freq == inline_at``. Per step the host
    milliseconds of the synchronized step (the service's hooks included),
    the loss, the step kind and, with ``keep_params``, the parameters after
    it; with the service, ``svc`` (closed)."""
    import torch

    from kfac_pytorch_tpu_torch import EigenRefreshCadence
    from kfac_pytorch_tpu_torch.service import CurvatureService
    from kfac_pytorch_tpu_torch.training.step import step_kind

    step_fn, state, kfac, batches, args = setup
    hp = kfac.hparams
    svc = None
    if budget is not None:
        svc = CurvatureService(kfac, EigenRefreshCadence(kfac), worker_devices=(device,),
                               staleness_budget=budget)
    out = {"step_ms": [], "loss": [], "kind": [], "params": [], "svc": svc}
    for step in range(steps):
        if svc is not None:
            flags = svc.cadence.flags_for_step(step)
        else:
            flags = {"update_factors": step % hp.fac_update_freq == 0,
                     "update_eigen": step % hp.kfac_update_freq == inline_at}
        # the trainer's stream only: a device-wide sync would wait for the
        # worker's stream too
        torch.cuda.current_stream().synchronize()
        t0 = time.perf_counter()
        if svc is not None:
            state.kfac_state = svc.before_step(step, state.kfac_state)
        state, metrics = step_fn(state, batches[step % len(batches)], args.base_lr,
                                 hp.damping, **flags)
        if svc is not None:
            svc.after_step(step, state.kfac_state)
        out["loss"].append(float(metrics["loss"]))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["kind"].append(step_kind(flags))
        if keep_params:
            out["params"].append([p.detach().clone() for p in state.model.parameters()])
    if svc is not None:
        svc.close()
    return out


def boundary_stats(run, freq, budget=0):
    """Median, p95 and max of the step times by kind (step 0, which pays
    first-call set-up, left out): ``boundary`` the steps ``s % freq == 0``
    (the inline refresh; the service's publish), ``after`` the ``1 +
    budget`` steps after each (the service's install, and its wait at the
    deadline), ``capture`` the others."""
    groups = {"capture": [], "boundary": [], "after": []}
    for s, ms in enumerate(run["step_ms"]):
        if s:
            groups["boundary" if s % freq == 0 else "after" if s % freq <= 1 + budget
                   else "capture"].append(ms)

    def dist(v):
        v = sorted(v)
        return {"median": statistics.median(v), "p95": v[min(len(v) - 1, int(0.95 * len(v)))],
                "max": v[-1], "n": len(v)}

    return {k: dist(v) for k, v in groups.items() if v}


def service_record(run):
    """A service run's worker refresh, publish, install and deadline-wait
    milliseconds (medians, and every refresh)."""
    svc = run["svc"]
    rec = svc.record
    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    return {"refresh_ms": svc.worker.refresh_ms, "refresh_ms_median": med(svc.worker.refresh_ms),
            "publish_ms_median": med(rec["publish_ms"]),
            "install_ms_median": med(rec["install_ms"]),
            "install_wait_ms": rec["install_wait_ms"], "installs": rec["installs"]}


def service_gate(device, counters):
    """29a's gate (see the comment above ``SERVICE_FREQ``)."""
    import torch

    extra = ["--kfac-update-freq", str(SERVICE_FREQ), "--kfac-cov-update-freq",
             str(SERVICE_GATE_FAC), "--steps-per-epoch", str(STEPS)]
    with eigh_by_thread() as eighs:
        run, launches = counted(lambda: service_steps(
            resnet_setup(device, [*extra, "--service-devices", "1"]), STEPS, budget=0,
            device=device, keep_params=True), counters)
    gate_launches(launches, cifar_expected_launches(run, device), "29a service gate")
    inline = service_steps(resnet_setup(device, extra), STEPS, inline_at=1, keep_params=True)
    bitwise, worst = run["loss"] == inline["loss"], 0.0
    for step, (got, want) in enumerate(zip(run["params"], inline["params"])):
        for g, w in zip(got, want):
            if torch.equal(g, w):
                continue
            bitwise = False
            rel = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            worst = max(worst, rel)
            if not rel <= SERVICE_RTOL:
                raise AssertionError(f"29a step {step}: the service's parameters differ from "
                                     f"the inline schedule's by {rel:.3e} (relative)")
    svc = run["svc"]
    refreshes = svc.worker.last_version
    want = -(-STEPS // SERVICE_FREQ)
    if eighs["trainer"] or refreshes != want or eighs["worker"] % refreshes:
        raise AssertionError(f"29a: eigh calls {eighs}, {refreshes} refreshes (want {want})")
    want_installs = [[v + 1, SERVICE_FREQ * v + 1, 0] for v in range(want)]
    if [list(i) for i in svc.record["installs"]] != want_installs:
        raise AssertionError(f"29a: installs {svc.record['installs']}, want {want_installs}")
    out = {"steps": STEPS, "refreshes": refreshes, "bitwise": bitwise, "max_rel_diff": worst,
           "trainer_eigh": eighs["trainer"],
           "worker_eigh_per_refresh": eighs["worker"] // refreshes,
           "installs": svc.record["installs"], "launches": launches}
    print(f"29a gate: staleness 0 against the inline refresh at boundary + 1 over {STEPS} steps: "
          f"{'bitwise' if bitwise else f'max relative difference {worst:.3e}'}; eigh calls: "
          f"trainer 0, worker {out['worker_eigh_per_refresh']} per refresh x {refreshes}",
          flush=True)
    return out


def service_timing(name, setup_fn, device, steps, freq):
    """29a's timing on one path: the inline run and the service at
    staleness 0 and 1, each from a fresh ``setup_fn(extra flags)``."""
    import torch

    out = {}
    for label, budget in (("inline", None), ("service_s0", 0), ("service_s1", 1)):
        extra = [] if budget is None else ["--service-devices", "1"]
        run = service_steps(setup_fn(extra), steps, budget=budget, device=device)
        if not all(math.isfinite(v) for v in run["loss"]):
            raise AssertionError(f"29a {name} {label}: non-finite loss {run['loss']}")
        out[label] = {"steps": boundary_stats(run, freq, budget or 0)}
        if budget is not None:
            out[label].update(service_record(run))
            deadline = [s for v, s, slip in run["svc"].record["installs"] if slip > budget]
            if deadline:
                raise AssertionError(f"29a {name} {label}: installs past the deadline {deadline}")
        del run
        torch.cuda.empty_cache()
        st = out[label]["steps"]
        line = ", ".join(f"{k} median {d['median']:.2f} p95 {d['p95']:.2f} max {d['max']:.2f} ms"
                         for k, d in st.items())
        extra = ""
        if budget is not None:
            extra = (f"; worker refresh {out[label]['refresh_ms_median']:.2f} ms (median), publish "
                     f"{out[label]['publish_ms_median']:.3f} ms, install "
                     f"{out[label]['install_ms_median']:.3f} ms, deadline waits "
                     f"{[round(w, 2) for w in out[label]['install_wait_ms']]} ms")
        print(f"29a {name} {label}: {line}{extra}", flush=True)
    return out


def service_rank_worker(rank, store, out_path, device_name):
    """One rank of phase 29b (``torch.multiprocessing`` target): the CIFAR
    twin and then the LM twin with ``--service-devices 1`` over gloo on
    ``cuda:0`` (rank 1 the worker), each with the launch counters zeroed
    just before it and ``torch.linalg.eigh`` counted."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_cifar10_resnet as cifar
    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm
    from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
    from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
    from kfac_pytorch_tpu_torch.ops import flash_attention as fa
    from kfac_pytorch_tpu_torch.parallel import launch

    counters = (fk.compute_a_conv_fused, fk.compute_a_embed_fused, ak.fused_precondition_stack,
                ak.fused_sgd_apply, fa.flash_forward, fa.flash_backward_dq,
                fa.flash_backward_dkv)
    launch.initialize(device_name, backend="gloo", init_method=f"file://{store}",
                      rank=rank, world_size=2)
    try:
        out = {}
        for name, main, argv in (
            ("resnet32", cifar.main, [*RESNET_ARGS, *SERVICE_CIFAR_FLAGS]),
            ("lm", lm.main, [*LM_ARGS, *SERVICE_LM_FLAGS]),
        ):
            with eigh_by_thread() as eighs:
                hist, launches = counted(
                    lambda: main([*argv, "--device", device_name, "--service-devices", "1"]),
                    counters)
            out[name] = {k: hist.get(k) for k in ("loss", "kind", "val_loss", "step_ms",
                                                  "refresh_ms", "service")}
            out[name].update(eigh=eighs["trainer"] + eighs["worker"], launches=launches)
        with open(f"{out_path}-{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        torch.distributed.destroy_process_group()


def service_ranks_phase(device, ranks):
    """29b (see the comment above ``SERVICE_FREQ``): ``ranks``,
    :func:`service_rank_worker`'s trainer and worker ranks' results."""
    import torch

    from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm_trainer

    trainer, worker = ranks
    model = lm_trainer.build(lm_trainer.parse_args(LM_ARGS), device)[0]
    lm_want = {LM_COUNTERS[k]: n for k, n in lm_expected_launches(trainer["lm"], model).items()}
    del model
    torch.cuda.empty_cache()
    out = {}
    for name, freq, expected in (
        ("resnet32", int(SHORT_CADENCE[1]), cifar_expected_launches(trainer["resnet32"], device)),
        ("lm", SERVICE_FREQ, lm_want),
    ):
        t, w = trainer[name], worker[name]
        if len(t["loss"]) != SERVICE_RANK_STEPS or not all(math.isfinite(v) for v in t["loss"]):
            raise AssertionError(f"29b {name}: losses {t['loss']}")
        if t["eigh"]:
            raise AssertionError(f"29b {name}: the trainer rank called eigh {t['eigh']} times")
        boundaries = -(-SERVICE_RANK_STEPS // freq)
        if w["loss"] or len(w["refresh_ms"]) != boundaries or not w["eigh"]:
            raise AssertionError(f"29b {name}: the worker served {len(w['refresh_ms'])} "
                                 f"refreshes with {w['eigh']} eigh calls, want {boundaries}")
        rec = t["service"]
        late = [(v, s) for v, s, slip in rec["installs"] if s > freq * (v - 1) + 1]
        if late or len(rec["installs"]) != boundaries:
            raise AssertionError(f"29b {name}: installs {rec['installs']}")
        gate_launches(t["launches"], expected, f"29b {name} trainer rank")
        out[name] = {
            "steps": SERVICE_RANK_STEPS, "installs": rec["installs"],
            "publish_ms": rec["publish_ms"], "install_ms": rec["install_ms"],
            "install_wait_ms": rec["install_wait_ms"], "worker_refresh_ms": w["refresh_ms"],
            "worker_eigh": w["eigh"], "trainer_eigh": 0, "launches": t["launches"],
            "step_ms_median": statistics.median(t["step_ms"][1:]),
        }
        print(f"29b {name} on two ranks: installs (version, step, slip) {rec['installs']}; "
              f"publish (npz write) {statistics.median(rec['publish_ms']):.2f} ms, install "
              f"{statistics.median(rec['install_ms']):.2f} ms (medians), worker refresh "
              f"{statistics.median(w['refresh_ms']):.2f} ms; trainer eigh calls 0", flush=True)
    return out


def service_phases(device, counters, ranks):
    """29a-b with deterministic cuDNN (its default algorithms differ from
    run to run in the last bits); ``ranks``: 29b's pooled results."""
    import torch

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        mark("29a. the curvature service in process: the staleness-0 gate, the step times")
        gate = service_gate(device, counters)
        resnet = service_timing(
            "ResNet-32", lambda extra: resnet_setup(device, [
                "--kfac-update-freq", str(SERVICE_FREQ), "--steps-per-epoch", str(STEPS),
                *extra]), device, STEPS, SERVICE_FREQ)
        lm = service_timing("LM", lambda extra: lm_setup(device, extra), device,
                            SERVICE_LM_STEPS, SERVICE_FREQ)
        mark("29b. the twins' --service-devices 1 on two ranks")
        ranks = service_ranks_phase(device, ranks)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    return {"gate": gate, "resnet32": resnet, "lm": lm, "two_ranks": ranks}


def ptxas_report():
    """``{kernel: [registers, spill store bytes]}`` for every kernel built,
    from the ``-Xptxas -v`` logs ``kernel_build`` keeps beside each library
    (names as compiled, mangled)."""
    from kfac_pytorch_tpu_torch.ops import kernel_build

    out, fn = {}, None
    for name in kernel_build.SIGNATURES:
        for line in (kernel_build.BUILD_DIR / f"lib{name}.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                out[fn] = [None, 0]
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn:
                out[fn][1] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                out[fn][0] = int(m.group(1))
    return out


_T0 = time.perf_counter()
_MARKS = []  # (phase, seconds since start) of every mark()


def mark(phase: str) -> None:
    """Print the seconds since start at the top of each phase."""
    _MARKS.append((phase, time.perf_counter() - _T0))
    print(f"[{_MARKS[-1][1]:7.1f} s] {phase}", flush=True)


def phase_seconds() -> dict:
    """``{phase: seconds}`` from each mark to the next (the last to now)."""
    ends = [t for _, t in _MARKS[1:]] + [time.perf_counter() - _T0]
    return {name: round(end - t, 1) for (name, t), end in zip(_MARKS, ends)}


def main() -> int:
    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("CUDA is not available: the port's main path runs on an NVIDIA GPU")
    try:
        from kfac_pytorch_tpu_torch.device import use_ieee_f32
        from kfac_pytorch_tpu_torch.examples import train_transformer_lm as lm_trainer
        from kfac_pytorch_tpu_torch.models import cifar_resnet, imagenet_resnet
        from kfac_pytorch_tpu_torch.ops import apply_kernels as ak
        from kfac_pytorch_tpu_torch.ops import factor_kernels as fk
        from kfac_pytorch_tpu_torch.ops import flash_attention as fa
        from kfac_pytorch_tpu_torch.ops import kernel_build
        from kfac_pytorch_tpu_torch.training import data as data_lib
        from kfac_pytorch_tpu_torch.training.data import synthetic_batches
    except ImportError as e:
        return _fail(f"the port is not importable ({e}); run from the repository root")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    use_ieee_f32()
    # zeroed before each profiled kernel-4 call: 128 MB, over the 50 MB L2
    flush = torch.empty(32 << 20, dtype=torch.float32, device=device)

    mark("2. build")
    # 2. build
    secs = kernel_build.build_all()
    print(f"build: {secs:.1f} s for {len(kernel_build.SIGNATURES)} sources (nvcc, sm_90a)", flush=True)
    if sys.argv[1:2] == ["--profile-edges"]:
        profile_edges(int(sys.argv[2]), ("plain", "guarded"),
                      (fk.compute_a_conv_fused, ak.fused_precondition_stack, ak.fused_sgd_apply))
        return 0
    ptxas = ptxas_report()
    print(json.dumps({"ptxas_registers_spill_bytes": ptxas}), flush=True)
    spilled = {fn: v for fn, v in ptxas.items()
               if v[1] and any(k in fn for k in ("chain_mma", "flash_fwd", "patch_cov"))}
    if spilled:
        raise AssertionError(f"the conv A, fused apply or flash forward kernels spill registers: {spilled}")

    def report(entries):
        for k in entries:
            device = (f", device {k['device_ms']:.4f} ms in {k['device_launches_per_call']:g} launch(es)"
                      if "device_ms" in k else "")
            print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3e}, "
                  f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library {k['library_ms']:.4f}, "
                  f"bound {k['bound_ms']:.4f} by {k['bound_by']}{device})", flush=True)
            for geo in k.get("costliest_geometries", []):
                print(f"  {geo['geometry']} x{geo['layers']}: {geo['ms']:.4f} ms (bound "
                      f"{geo['bound_ms']:.4f}), route {json.dumps(geo['route'])}", flush=True)

    mark("3. ResNet kernels")
    # 3. ResNet kernels against their plain versions, at the ResNet path's shapes
    model = cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0)).to(device)
    xb, _ = next(synthetic_batches(BATCH, (3, 32, 32), 10, 1, seed=0))
    images = torch.from_numpy(xb).to(device)
    conv_a = conv_a_phase(model, images)
    resnet_apply = apply_phase(model, device)
    resnet_sgd = sgd_phase(model, device, 0.1, 0.9, 5e-4, flush)
    report([conv_a, resnet_apply, resnet_sgd])
    mark("3b. ResNet kernels, bf16 routes")
    # (a, b) kernel 1's bf16 route on the activations of a bfloat16 forward,
    # kernel 3's bf16-Q route on the same shape groups
    bf16_model = cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0),
                                        dtype=torch.bfloat16).to(device)
    conv_a_bf16 = conv_a_phase(bf16_model, images, bf16=True)
    resnet_apply_bf16 = apply_phase(model, device, torch.bfloat16)
    report([conv_a_bf16, resnet_apply_bf16])
    del model, bf16_model

    mark("4. ResNet training")
    # 4. the ResNet path through its trainer, counters zeroed just before
    all_counted = (fk.compute_a_conv_fused, fk.compute_a_conv_grouped_fused, fk.compute_a_embed_fused,
                   ak.fused_precondition_stack, ak.fused_sgd_apply, fa.flash_forward,
                   fa.flash_backward_dq, fa.flash_backward_dkv)
    hist, resnet_launches = counted(lambda: train([]), all_counted)
    losses = hist["loss"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"loss did not fall: first-5 mean {first:.4f}, last-5 mean {last:.4f}")
    resnet_expected = conv_expected_launches(
        hist, cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0)), device)
    for name, n in resnet_launches.items():
        if n != resnet_expected.get(name, 0):
            raise AssertionError(
                f"{name}: {n} launches on the ResNet path, the run implies {resnet_expected.get(name, 0)}")
    for k, fn in ((conv_a, fk.compute_a_conv_fused), (resnet_apply, ak.fused_precondition_stack),
                  (resnet_sgd, ak.fused_sgd_apply)):
        n = resnet_launches[fn.__name__]
        if n <= 0:
            raise AssertionError(f"{k['name']} was never launched on the ResNet path")
        k["launches"] = n
        k["launches_per_step"] = n / STEPS
    sgd = train(["--kfac-update-freq", "0"])
    kfac_stats, sgd_stats = step_stats(hist, BATCH), step_stats(sgd, BATCH)
    print(json.dumps({
        "main_path": f"{MODEL} batch {BATCH}, {STEPS} steps, synthetic 32x32x3",
        "loss_first5": first, "loss_last5": last,
        "step0_ms": kfac_stats["step0_ms"],
        "capture_step_ms_median": kfac_stats["capture_ms_median"],
        "refresh_step_ms_median": kfac_stats["refresh_ms_median"],
        "images_per_s": kfac_stats["per_s"],
        "sgd_step_ms_median": sgd_stats["plain_ms_median"],
        "sgd_images_per_s": sgd_stats["per_s"],
        "kfac_over_sgd_mean_step": kfac_stats["mean_ms"] / sgd_stats["mean_ms"],
        "launches": resnet_launches,
        "expected_launches": resnet_expected,
    }), flush=True)

    mark("5. ResNet oracle")
    # 5. the ResNet kernel path against the oracle paths on the first steps
    dense = train(["--factor-kernel", "dense", "--apply-kernel", "dense"])
    for i in range(5):
        a, b = losses[i], dense["loss"][i]
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"step {i}: kernel-path loss {a} vs oracle-path loss {b}")
    print(f"oracle paths: first 5 losses agree to 1e-3 relative "
          f"(max diff {max(abs(a - b) for a, b in zip(losses[:5], dense['loss'][:5])):.3e})", flush=True)

    mark("6. ResNet profile")
    # 6. where the ResNet step's device time goes: 9 capture steps between
    # the refreshes at steps 0 and 10, and 10 plain-SGD steps
    resnet_profile = profile_path(resnet_setup, device, [
        (("--steps-per-epoch", "10"), [("capture", 1, 10)]),
        (("--steps-per-epoch", "12", "--kfac-update-freq", "0"), [("sgd", 2, 12)]),
    ])
    print(json.dumps({"resnet_profile": resnet_profile}), flush=True)
    gate_profile_launches(resnet_profile, "resnet")

    mark("7. LM kernels")
    # 7. LM kernels against their plain versions, at the LM path's shapes
    args = lm_trainer.parse_args(LM_ARGS)
    splits, words = data_lib.synthetic_corpus(vocab_size=lm_trainer.SYNTHETIC_VOCAB)
    toks, _ = next(data_lib.bptt_batches(
        data_lib.batchify_tokens(splits["train"], args.batch_size), args.seq_len))
    lm_model = lm_trainer.build(args, device)[0]
    lm_ids = lm_trainer.device_batch(toks, toks, device)[0]
    token_count = token_count_phase(lm_ids, len(words))
    flash = flash_phase(device, args.batch_size, args.seq_len, args.n_heads,
                        args.d_model // args.n_heads)
    lm_apply = apply_phase(lm_model, device)
    lm_apply_bf16 = apply_phase(lm_model, device, torch.bfloat16)
    lm_sgd = sgd_phase(lm_model, device, args.base_lr, args.momentum, args.wd, flush)
    report([token_count, *flash, lm_apply, lm_apply_bf16, lm_sgd])

    mark("8. LM training")
    # 8. the LM path through its trainer twin, counters zeroed just before
    lm_hist, lm_launches = counted(lambda: train_lm(["--epochs", str(LM_EPOCHS)]), all_counted)
    lm_losses = lm_hist["loss"]
    if not all(math.isfinite(v) for v in lm_losses + lm_hist["val_loss"]):
        raise AssertionError(f"non-finite LM loss: {lm_losses} {lm_hist['val_loss']}")
    lm_first, lm_last = statistics.mean(lm_losses[:5]), statistics.mean(lm_losses[-5:])
    if not lm_last < lm_first:
        raise AssertionError(f"LM loss did not fall: first-5 mean {lm_first:.4f}, last-5 mean {lm_last:.4f}")
    expected = lm_expected_launches(lm_hist, lm_model)
    lm_kernels = {
        "token_count": (token_count, fk.compute_a_embed_fused),
        "fused_apply": (lm_apply, ak.fused_precondition_stack),
        "fused_sgd": (lm_sgd, ak.fused_sgd_apply),
        "flash_forward": (flash[0], fa.flash_forward),
        "flash_dq": (flash[1], fa.flash_backward_dq),
        "flash_dkv": (flash[2], fa.flash_backward_dkv),
    }
    lm_steps = len(lm_losses)
    for key, (k, fn) in lm_kernels.items():
        n = lm_launches[fn.__name__]
        if n <= 0 or n != expected[key]:
            raise AssertionError(
                f"{k['name']}: {n} launches on the LM path, the run implies {expected[key]}"
            )
        k["launches"] = n
        k["launches_per_step"] = n / lm_steps
    if lm_launches["compute_a_conv_fused"] or lm_launches["compute_a_conv_grouped_fused"]:
        raise AssertionError("a conv A kernel ran on the LM path, which has no conv")
    lm_sgd_hist = train_lm(["--epochs", "1", "--kfac-update-freq", "0"])
    tokens = args.batch_size * args.seq_len
    lm_stats, lm_sgd_stats = step_stats(lm_hist, tokens), step_stats(lm_sgd_hist, tokens)
    print(json.dumps({
        "lm_path": (f"transformer LM d{args.d_model} h{args.n_heads} L{args.n_layers} "
                    f"T{args.seq_len} B{args.batch_size}, vocab {len(words)}, "
                    f"--kfac-embedding, {lm_steps} steps"),
        "loss_first5": lm_first, "loss_last5": lm_last, "val_loss": lm_hist["val_loss"],
        "step0_ms": lm_stats["step0_ms"],
        "capture_step_ms_median": lm_stats["capture_ms_median"],
        "refresh_step_ms_median": lm_stats["refresh_ms_median"],
        "tokens_per_s": lm_stats["per_s"],
        "sgd_step_ms_median": lm_sgd_stats["plain_ms_median"],
        "sgd_tokens_per_s": lm_sgd_stats["per_s"],
        "kfac_over_sgd_mean_step": lm_stats["mean_ms"] / lm_sgd_stats["mean_ms"],
        "launches": lm_launches,
        "expected_launches": expected,
    }), flush=True)

    mark("9. LM oracle")
    # 9. the LM kernel path against the oracle path on the first steps
    del lm_model
    oracle = lm_oracle_losses(device, ORACLE_STEPS)
    for i, (a, b) in enumerate(zip(lm_losses, oracle)):
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"LM step {i}: kernel-path loss {a} vs oracle-path loss {b}")
    print(f"LM oracle path: first {ORACLE_STEPS} losses agree to 1e-3 relative "
          f"(max diff {max(abs(a - b) for a, b in zip(lm_losses, oracle)):.3e})", flush=True)

    mark("10. LM profile")
    # 10. where the LM step's device time goes
    lm_profile = profile_lm(device)
    print(json.dumps({"lm_profile": lm_profile}), flush=True)
    gate_profile_launches(lm_profile, "lm")

    mark("11. ResNeXt kernels")
    # 11. ResNeXt kernels against their plain versions, at the ImageNet path's
    # shapes: activations from one forward of ResNeXt-50 at batch 32, 224x224
    rx_model = imagenet_resnet.get_model(
        IMAGENET_MODEL, generator=torch.Generator().manual_seed(0)).to(device)
    xb, _ = next(synthetic_batches(IMAGENET_BATCH, (3, 224, 224), 1000, 1, seed=0))
    rx_images = torch.from_numpy(xb).to(device)
    rx_conv_a = conv_a_phase(rx_model, rx_images)
    grouped_a = grouped_conv_a_phase(rx_model, rx_images)
    rx_apply = apply_phase(rx_model, device)
    rx_sgd = sgd_phase(rx_model, device, 0.0125, 0.9, 5e-5, flush)
    report([rx_conv_a, grouped_a, rx_apply, rx_sgd])
    torch.cuda.empty_cache()
    mark("11b. ResNeXt kernels, bf16 routes")
    # (a, b) kernels 1 and 1g on their bf16 route on the activations of a
    # bfloat16 forward, kernel 3 on its bf16-Q route at ResNeXt's groups
    rx_bf16 = imagenet_resnet.get_model(IMAGENET_MODEL, generator=torch.Generator().manual_seed(0),
                                        dtype=torch.bfloat16).to(device)
    rx_conv_a_bf16 = conv_a_phase(rx_bf16, rx_images, bf16=True)
    grouped_a_bf16 = grouped_conv_a_phase(rx_bf16, rx_images, bf16=True)
    del rx_images, rx_bf16
    rx_apply_bf16 = apply_phase(rx_model, device, torch.bfloat16)
    report([rx_conv_a_bf16, grouped_a_bf16, rx_apply_bf16])
    torch.cuda.empty_cache()

    mark("12. ResNeXt training")
    # 12. the ResNeXt path through its trainer twin, counters zeroed just before
    rx_hist, rx_launches = counted(
        lambda: train_imagenet(["--steps-per-epoch", str(IMAGENET_STEPS)]), all_counted)
    rx_losses = rx_hist["loss"]
    if not all(math.isfinite(v) for v in rx_losses):
        raise AssertionError(f"non-finite ResNeXt loss: {rx_losses}")
    rx_first, rx_last = statistics.mean(rx_losses[:5]), statistics.mean(rx_losses[-5:])
    if not rx_last < rx_first:
        raise AssertionError(f"ResNeXt loss did not fall: first-5 mean {rx_first:.4f}, last-5 mean {rx_last:.4f}")
    expected = conv_expected_launches(rx_hist, rx_model, device)
    for name, n in rx_launches.items():
        if n != expected.get(name, 0):
            raise AssertionError(
                f"{name}: {n} launches on the ResNeXt path, the run implies {expected.get(name, 0)}")
    for k, fn in ((rx_conv_a, fk.compute_a_conv_fused), (grouped_a, fk.compute_a_conv_grouped_fused),
                  (rx_apply, ak.fused_precondition_stack), (rx_sgd, ak.fused_sgd_apply)):
        k["launches"] = rx_launches[fn.__name__]
        k["launches_per_step"] = k["launches"] / IMAGENET_STEPS
    del rx_model
    rx_sgd_hist = train_imagenet(["--steps-per-epoch", "10", "--kfac-update-freq", "0"])
    rx_stats, rx_sgd_stats = step_stats(rx_hist, IMAGENET_BATCH), step_stats(rx_sgd_hist, IMAGENET_BATCH)
    print(json.dumps({
        "imagenet_path": (f"{IMAGENET_MODEL} batch {IMAGENET_BATCH}, {IMAGENET_STEPS} steps, "
                          "synthetic 224x224x3, 1000 classes"),
        "loss_first5": rx_first, "loss_last5": rx_last,
        "step0_ms": rx_stats["step0_ms"],
        "capture_step_ms_median": rx_stats["capture_ms_median"],
        "refresh_step_ms_median": rx_stats["refresh_ms_median"],
        "images_per_s": rx_stats["per_s"],
        "sgd_step_ms_median": rx_sgd_stats["plain_ms_median"],
        "sgd_images_per_s": rx_sgd_stats["per_s"],
        "kfac_over_sgd_mean_step": rx_stats["mean_ms"] / rx_sgd_stats["mean_ms"],
        "launches": rx_launches,
        "expected_launches": expected,
    }), flush=True)

    mark("13. ResNeXt oracle")
    # 13. the ResNeXt kernel path against the oracle paths on the first steps:
    # the gate holds each oracle step, taken from the kernel path's state, to
    # the kernel path's loss (free-running, this configuration carries one
    # step's rounding, and cuDNN's run-to-run noise, to ~1e-2 in 3-4 steps
    # on an NVIDIA H100 80GB HBM3 at 700 W)
    rx_kernel, rx_oracle = one_step_oracle(imagenet_setup, device, ORACLE_STEPS)
    rx_oracle_rel = max(abs(a - b) / abs(b) for a, b in zip(rx_kernel, rx_oracle))
    if not rx_oracle_rel <= 1e-3:
        raise AssertionError(f"ResNeXt kernel-path losses {rx_kernel} vs one-step oracle {rx_oracle}")
    print(json.dumps({"imagenet_oracle": {
        "one_step": {"kernel": rx_kernel, "oracle": rx_oracle, "max_rel_diff": rx_oracle_rel,
                     "tolerance": "1e-3 relative per step"},
    }}), flush=True)
    print(f"ResNeXt oracle paths: first {ORACLE_STEPS} losses, each oracle step from the kernel "
          f"path's state, agree to 1e-3 relative (max {rx_oracle_rel:.3e})", flush=True)

    mark("14. ResNeXt profile")
    # 14. where the ResNeXt step's device time goes: 6 K-FAC steps holding
    # one refresh, 3 capture steps, 5 plain-SGD steps
    rx_profile = profile_path(imagenet_setup, device, [
        (("--steps-per-epoch", "15"), [("kfac", 6, 12), ("capture", 12, 15)]),
        (("--steps-per-epoch", "7", "--kfac-update-freq", "0"), [("sgd", 2, 7)]),
    ])
    print(json.dumps({"imagenet_profile": rx_profile}), flush=True)
    gate_profile_launches(rx_profile, "imagenet")

    mark("15. CUDA graphs")
    # 15. kernels 4 (ResNeXt's leaf set) and 2 (the LM batch) captured in CUDA
    # graphs and replayed on new inputs: no host sync, results as eager
    graphs = graph_phase(
        imagenet_resnet.get_model(IMAGENET_MODEL, generator=torch.Generator().manual_seed(0)),
        lm_ids, len(words), device, 0.0125, 0.9, 5e-5)
    print(json.dumps({"cuda_graphs": graphs}), flush=True)
    token_count["cuda_graph"] = graphs["token_count"]
    rx_sgd["cuda_graph"] = graphs["fused_sgd"]

    # 16a-f. the CIFAR-10 main path with data and the JAX trainer's options:
    # each path driven through the twin with the counters zeroed just before
    cifar = cifar_phases(device, all_counted, kfac_stats)
    print(json.dumps({"cifar_paths": cifar}), flush=True)
    for k, fn in ((conv_a, fk.compute_a_conv_fused), (resnet_apply, ak.fused_precondition_stack),
                  (resnet_sgd, ak.fused_sgd_apply)):
        k["launches_on_cifar_paths"] = {p: n[fn.__name__] for p, n in cifar["launches"].items()}

    # 17a-d. the bf16 modes on ResNet-32 and on this slice's path, ResNeXt-50
    # with --bf16 --eigen-dtype bf16; --precond-precision; the ImageNet and
    # LM twins' bookkeeping: each path with the counters zeroed just before
    mark("17a. ResNet-32 --bf16 --eigen-dtype bf16")
    bf16_resnet = bf16_resnet_phase(device, all_counted, kfac_stats)
    print(json.dumps({"bf16_resnet": bf16_resnet}), flush=True)
    mark("17b. ResNeXt-50 --bf16 --eigen-dtype bf16")
    bf16_rx = bf16_imagenet_phase(device, all_counted, rx_stats)
    print(json.dumps({"bf16_imagenet": bf16_rx}), flush=True)
    mark("17c. --precond-precision default")
    precision = precision_phase(device)
    print(json.dumps({"precond_precision": precision}), flush=True)
    mark("17d. ImageNet and LM twins' bookkeeping")
    book = bookkeeping_phase(device, all_counted)
    print(json.dumps({"twins_bookkeeping": book}), flush=True)
    for k, path, key in ((conv_a_bf16, bf16_resnet, "compute_a_conv_fused:bf16"),
                         (resnet_apply_bf16, bf16_resnet, "fused_precondition_stack:bf16"),
                         (rx_conv_a_bf16, bf16_rx, "compute_a_conv_fused:bf16"),
                         (grouped_a_bf16, bf16_rx, "compute_a_conv_grouped_fused:bf16"),
                         (rx_apply_bf16, bf16_rx, "fused_precondition_stack:bf16")):
        k["launches"] = path["launches"][key]
        k["launches_per_step"] = k["launches"] / (STEPS if path is bf16_resnet else IMAGENET_STEPS)
    lm_apply_bf16["launches"] = 0
    lm_apply_bf16["launches_note"] = "the LM trainer has no --eigen-dtype (nor has the JAX one)"

    # 18a-d. the ImageNet data path: shards, augmentation, full-split
    # evaluation, evaluate.py and --init-from-torch, on ResNet-50
    shard_root = tempfile.TemporaryDirectory(prefix="kfac_chip_smoke_shards_")
    shards, rn50_conv_a, d256 = imagenet_data_phases(device, all_counted, shard_root.name)
    print(json.dumps({"imagenet_shards": shards}), flush=True)
    report([rn50_conv_a])
    # 19a-d. the WikiText LSTM twin, a WikiText-2-sized vocabulary, the tied
    # head with its reduce lens, the other cells, a resume, and the
    # transformer LM's tied head
    wikitext, wt_rows = wikitext_phases(device, all_counted, flush)
    print(json.dumps({"wikitext": wikitext}), flush=True)
    report([wt_rows["apply"], wt_rows["sgd"], wt_rows["token_count"]])

    # 20a-d. this slice: the native loader on 18b's shards; the CIFAR twin
    # through the distributed code on NCCL at world 1; two ranks on the one
    # card with the distributed K-FAC; the float32 syevd watch item
    mark("20a. native loader")
    loader = loader_phase(device, all_counted, d256, shards["rrc"])
    shard_root.cleanup()
    print(json.dumps({"native_loader": loader}), flush=True)
    mark("20b. NCCL world 1")
    print(f"torch.cuda.device_count() = {torch.cuda.device_count()}", flush=True)
    world1 = world1_phase(device, all_counted)
    print(json.dumps({"nccl_world_1": world1}), flush=True)
    mark("20c-29b. the two-rank phases' ranks, one pool")
    # every two-rank phase's ranks (20c, 21e, 22b-c, 23b-d, 24d, 25c, 26b,
    # 27c, 29b) run here in one spawn; each phase below gates its results
    torch.cuda.empty_cache()
    tp_argv = [*LM_ARGS, *MOE_FLAGS, "--tensor-parallel", "2"]
    pooled, pool_seconds = rank_pool([
        (two_rank_worker, (TWO_RANK_STEPS, str(device), list(TWO_RANK_ARGS))),
        (two_rank_worker, (TWO_RANK_STEPS, str(device), list(TWO_RANK_SOLVER_ARGS))),
        (comm_worker, (COMM_STEPS, str(device), COMM_RUNS)),
        (owner_worker, (OWNER_STEPS, str(device), OWNER_RUNS)),
        (seq_worker, (SEQ_STEPS, str(device), [*LM_ARGS, *SHORT_CADENCE], list(SEQ_KINDS))),
        (tp_worker, (TP_STEPS, str(device), tp_argv)),
        (fsdp_worker, (TP_STEPS, str(device), [*LM_ARGS, *FSDP_TP_FLAGS], 2)),
        (telemetry_rank_worker, (TELEMETRY_RANK_STEPS, "cuda:0")),
        (service_rank_worker, ("cuda:0",)),
    ], POOL_TIMEOUT_S)
    print(json.dumps({"rank_pool_seconds": pool_seconds}), flush=True)
    (two_rank_res, two_solver_res, comm_res, owner_res, seq_res, tp_res, fsdp_tp_res, tel_res,
     service_res) = pooled
    del pooled
    mark("20c. two ranks on one card")
    two_ranks = two_rank_phase(device, two_rank_res)
    print(json.dumps({"two_ranks": two_ranks}), flush=True)
    mark("20d. float32 syevd at 26,733")
    syevd = syevd_watch_phase(device)
    print(json.dumps({"syevd_watch": syevd}), flush=True)
    conv_a["resnet32_two_ranks"] = {"launches_per_rank": [
        r["launches"]["compute_a_conv_fused"] for r in two_ranks["ranks"]]}

    # 21a-e. this slice: the pipelined refresh on ResNet-32, the truncated
    # solvers on the LM, at WikiText-2's vocabulary and (streaming) on the
    # LSTM, and both across two ranks of the one card; each path with the
    # counters zeroed just before
    mark("21a. ResNet-32 --eigh-chunks")
    chunks = chunks_phase(device, all_counted, kfac_stats)
    print(json.dumps({"eigh_chunks": chunks}), flush=True)
    mark("21b. LM --solver rsvd")
    lm_rsvd = lm_rsvd_phase(device, all_counted, lm_stats)
    print(json.dumps({"lm_rsvd": lm_rsvd}), flush=True)
    mark("21c. WikiText-2 vocabulary --solver rsvd")
    wide_rsvd = wide_rsvd_phase(device, all_counted, wikitext["wikitext2"])
    print(json.dumps({"wikitext2_rsvd": wide_rsvd}), flush=True)
    mark("21d. WikiText LSTM --solver streaming")
    streaming = streaming_phase(device, all_counted, wikitext["lstm"])
    print(json.dumps({"lstm_streaming": streaming}), flush=True)
    mark("21e. two ranks, --eigh-chunks 2 --solver rsvd")
    two_solver = two_rank_phase(device, two_solver_res, TWO_RANK_SOLVER_ARGS)
    print(json.dumps({"two_ranks_chunks_rsvd": two_solver}), flush=True)
    for res in two_solver["ranks"]:
        if "chunk-swap" not in res["kinds"] or not res["truncated_sides"]:
            raise AssertionError(f"21e, rank {res['rank']}: step kinds {res['kinds']}, "
                                 f"{res['truncated_sides']} truncated sides")
    # kernel 3's launches on the truncated and chunked paths, beside its rows
    lm_apply["launches_on_slice12_paths"] = {
        "resnet32_eigh_chunks5": chunks["launches"]["fused_precondition_stack"],
        "lm_rsvd": lm_rsvd["launches"]["fused_precondition_stack"],
        "wikitext2_rsvd": wide_rsvd["launches"]["fused_precondition_stack"],
        "wikitext_lstm_streaming": streaming["launches"]["fused_precondition_stack"],
        "resnet32_two_ranks_chunks_rsvd": [r["launches"]["fused_precondition_stack"]
                                           for r in two_solver["ranks"]],
    }
    conv_a["launches_on_slice12_paths"] = {
        "resnet32_eigh_chunks5": chunks["launches"]["compute_a_conv_fused"],
        "resnet32_two_ranks_chunks_rsvd": [r["launches"]["compute_a_conv_fused"]
                                           for r in two_solver["ranks"]],
    }
    lm_sgd["launches_on_slice12_paths"] = {
        "resnet32_eigh_chunks5": chunks["launches"]["fused_sgd_apply"],
        "lm_rsvd": lm_rsvd["launches"]["fused_sgd_apply"],
        "wikitext2_rsvd": wide_rsvd["launches"]["fused_sgd_apply"],
        "wikitext_lstm_streaming": streaming["launches"]["fused_sgd_apply"],
    }
    token_count["launches_on_slice12_paths"] = {
        "lm_rsvd": lm_rsvd["launches"]["compute_a_embed_fused"]}
    for k, fn in zip(flash, ("flash_forward", "flash_backward_dq", "flash_backward_dkv")):
        k["launches_on_slice12_paths"] = {"lm_rsvd": lm_rsvd["launches"][fn]}
    lm_apply["resnet32_two_ranks"] = {"launches_per_rank": [
        r["launches"]["fused_precondition_stack"] for r in two_ranks["ranks"]]}
    lm_sgd["resnet32_two_ranks"] = {"launches_per_rank": [
        r["launches"]["fused_sgd_apply"] for r in two_ranks["ranks"]]}

    # 22a-c. this slice: the factor comm plane and the LM twins across
    # ranks; the LM at NCCL world 1 and, with the LSTM, on two ranks of
    # the one card, each path with the counters zeroed just before
    mark("22a. LM, NCCL world 1, the comm plane's levers")
    lm_world1 = lm_world1_phase(device, all_counted, lm_hist, lm_stats["capture_ms_median"],
                                world1)
    print(json.dumps({"lm_nccl_world_1": lm_world1}), flush=True)
    mark("22b-c. two ranks: LM bf16 wires, LSTM int8 wire")
    comm = comm_phase(device, comm_res)
    print(json.dumps({"two_ranks_comm": comm}), flush=True)
    w1 = lm_world1["launches"]
    for k, key in ((conv_a, "compute_a_conv_fused"), (token_count, "compute_a_embed_fused"),
                   (lm_apply, "fused_precondition_stack"), (lm_sgd, "fused_sgd_apply"),
                   (flash[0], "flash_forward"), (flash[1], "flash_backward_dq"),
                   (flash[2], "flash_backward_dkv")):
        k["launches_on_slice13_paths"] = {"lm_nccl_world1": w1[key], **{
            f"{name}_two_ranks_per_rank": [r["runs"][name]["launches"][key] for r in comm["ranks"]]
            for name, _, _ in COMM_RUNS}}

    # 23a-e. this slice: owner-sharded factor state and the overlap plane;
    # at NCCL world 1 (inert) and on two ranks of the one card, each path
    # with the counters zeroed just before
    mark("23a. owner + overlap, NCCL world 1")
    owner_world1 = owner_world1_phase(device, all_counted, lm_hist)
    print(json.dumps({"owner_nccl_world_1": owner_world1}), flush=True)
    mark("23b-d. two ranks: owner-sharded ResNet-32, LM, LSTM")
    owner = owner_phase(device, owner_res)
    print(json.dumps({"two_ranks_owner": owner}), flush=True)
    # kernel 3 on each rank's owned shape groups, at the two paths' shapes
    owner_models = {
        "resnet32": cifar_resnet.get_model(MODEL, generator=torch.Generator().manual_seed(0)),
        "lm": lm_trainer.build(lm_trainer.parse_args(LM_ARGS), device)[0],
    }
    for name, m in owner_models.items():
        lm_apply[f"{name}_owner_two_ranks"] = [apply_phase(m.to(device), device, owner_rank=r)
                                               for r in (0, 1)]
    del owner_models
    for k, key in ((conv_a, "compute_a_conv_fused"), (token_count, "compute_a_embed_fused"),
                   (lm_apply, "fused_precondition_stack"), (lm_sgd, "fused_sgd_apply"),
                   (flash[0], "flash_forward"), (flash[1], "flash_backward_dq"),
                   (flash[2], "flash_backward_dkv")):
        k["launches_on_slice14_paths"] = {
            "resnet32_owner_nccl_world1": owner_world1["launches"]["resnet32"].get(key, 0),
            "lm_owner_nccl_world1": owner_world1["launches"]["lm"].get(key, 0), **{
                f"{name}_two_ranks_per_rank": [r["runs"][name]["launches"].get(key, 0)
                                               for r in owner["ranks"]]
                for name, _, _ in OWNER_RUNS}}

    # 24a-e. this slice: the LM's extras (the QKV expand lens, remat,
    # dropout) and sequence parallelism on two ranks of the one card, each
    # path with the counters zeroed just before; flash backward's error at
    # long sequences
    mark("24a. LM --qkv-lens")
    lens, lens_apply = lens_phase(device, all_counted, lm_stats)
    print(json.dumps({"lm_qkv_lens": lens}), flush=True)
    report([lens_apply])
    mark("24b. LM --remat, dropout")
    remat = remat_phase(device, all_counted, lm_hist)
    print(json.dumps({"lm_remat": remat}), flush=True)
    mark("24c. flash backward at T = 4096, 8192 and 16384")
    flash_long = flash_long_phase(device, ptxas)
    print(json.dumps({"flash_backward_long": flash_long}), flush=True)
    mark("24d. two ranks: --seq-parallel 2, ring and Ulysses")
    seq = seq_parallel_phase(seq_res, oracle)
    print(json.dumps({"two_ranks_seq_parallel": seq}), flush=True)
    # 24e. every kernel's launches on this slice's paths
    for k, key in ((token_count, "compute_a_embed_fused"), (lm_apply, "fused_precondition_stack"),
                   (lm_sgd, "fused_sgd_apply"), (flash[0], "flash_forward"),
                   (flash[1], "flash_backward_dq"), (flash[2], "flash_backward_dkv")):
        k["launches_on_slice15_paths"] = {
            "lm_qkv_lens": lens["launches"][key], "lm_remat": remat["launches"][key], **{
                f"lm_seq_parallel_{kind}_per_rank": [r["runs"][kind]["launches"][key]
                                                     for r in seq["ranks"]]
                for kind in SEQ_KINDS}}
    lm_apply["lm_qkv_lens"] = lens_apply

    # 25a-c. this slice: the shard lenses (the MoE bank, the column/row
    # lens model) and the data×tensor world, each path with the counters
    # zeroed just before
    mark("25a. LM --moe-experts 4")
    moe, moe_dispatch = moe_phase(device, all_counted, lm_stats)
    print(json.dumps({"lm_moe": moe}), flush=True)
    report([moe_dispatch])
    mark("25b. tensor_parallel=2 lens model")
    tp_lens = tp_lens_phase(device, all_counted, lm_stats)
    print(json.dumps({"lm_tensor_parallel_lens": tp_lens}), flush=True)
    mark("25c. two ranks: --tensor-parallel 2 --moe-experts 4")
    tp = tp_phase(tp_res, tp_one_process(device), tp_argv)
    print(json.dumps({"two_ranks_tensor_parallel": tp}), flush=True)
    for k, key in ((token_count, "compute_a_embed_fused"), (lm_apply, "fused_precondition_stack"),
                   (lm_sgd, "fused_sgd_apply"), (flash[0], "flash_forward"),
                   (flash[1], "flash_backward_dq"), (flash[2], "flash_backward_dkv")):
        k["launches_on_slice16_paths"] = {
            "lm_moe": moe["launches"][key], "lm_tensor_parallel_lens": tp_lens["launches"][key],
            "lm_tensor_parallel_moe_two_ranks_per_rank": [r["launches"][key]
                                                          for r in tp["ranks"]]}

    # 26a-c. this slice: the 3-D data×fsdp×tensor world, each path with the
    # counters zeroed just before
    mark("26a. --fsdp 1 --tensor-parallel 1, NCCL world 1")
    fsdp_w1 = fsdp_world1_phase(device, all_counted, lm_hist)
    print(json.dumps({"lm_fsdp_nccl_world_1": fsdp_w1}), flush=True)
    mark("26b. two ranks: --fsdp 1 --tensor-parallel 2")
    fsdp_tp_argv = [*LM_ARGS, *FSDP_TP_FLAGS]
    if len(tp_lens["losses"]) != TP_STEPS:
        raise AssertionError(f"25b took {len(tp_lens['losses'])} steps, not {TP_STEPS}")
    fsdp_tp = fsdp_tp_phase(fsdp_tp_res, tp_lens, fsdp_tp_argv)
    print(json.dumps({"two_ranks_fsdp_tensor": fsdp_tp}), flush=True)
    mark("26c. four ranks: --fsdp 2 --tensor-parallel 2")
    fsdp_3d_argv = [*LM_ARGS, *FSDP_3D_FLAGS]
    one_3d, wire_3d = fsdp_one_process(device)
    fsdp_3d, sgd_3d = fsdp_3d_phase(fsdp_ranks(device, fsdp_3d_argv, FSDP_3D_STEPS, 4),
                                    one_3d, fsdp_3d_argv)
    fsdp_3d["int8_wire_per_rank_and_flush"] = wire_3d
    print(json.dumps({"four_ranks_fsdp_tensor": fsdp_3d}), flush=True)
    report([sgd_3d])
    for k, key in ((token_count, "compute_a_embed_fused"), (lm_apply, "fused_precondition_stack"),
                   (lm_sgd, "fused_sgd_apply"), (flash[0], "flash_forward"),
                   (flash[1], "flash_backward_dq"), (flash[2], "flash_backward_dkv")):
        k["launches_on_slice17_paths"] = {
            "lm_fsdp1_tp1_nccl_world1": fsdp_w1["launches"][key],
            "lm_fsdp1_tp2_two_ranks_per_rank": [r["launches"][key] for r in fsdp_tp["ranks"]],
            "lm_fsdp2_tp2_four_ranks_per_rank": [r["launches"][key] for r in fsdp_3d["ranks"]]}

    # 27a-c. this slice: telemetry, the profiler hook and the planner, each
    # path with the counters zeroed just before it
    mark("27a. ResNet-32: telemetry, the profiler trace, --profile safe")
    tel27, resnet_dense_ms = telemetry_phase(device, all_counted)
    print(json.dumps({"resnet_telemetry": tel27}), flush=True)
    mark("27b. --profile production --autotune-steps 2: ResNet-32 and the LM")
    planned = {"resnet32": planner_run(device, all_counted, "resnet", resnet_dense_ms),
               "lm": planner_run(device, all_counted, "lm", dense_refresh_ms(lm_hist))}
    print(json.dumps({"planner_production": planned}), flush=True)
    mark("27c. two ranks: the rank-aware telemetry summary")
    tel_ranks = telemetry_ranks_phase(tel_res)
    print(json.dumps({"two_ranks_telemetry": tel_ranks}), flush=True)
    for k, key in ((conv_a, "compute_a_conv_fused"), (resnet_apply, "fused_precondition_stack"),
                   (resnet_sgd, "fused_sgd_apply")):
        k["launches_on_slice18_paths"] = {
            "resnet32_telemetry_on_off_profiled": tel27["launches"][key],
            "resnet32_production_autotuned": planned["resnet32"]["launches"][key]}
    for k, key in ((token_count, "compute_a_embed_fused"), (lm_apply, "fused_precondition_stack"),
                   (lm_sgd, "fused_sgd_apply"), (flash[0], "flash_forward"),
                   (flash[1], "flash_backward_dq"), (flash[2], "flash_backward_dkv")):
        k["launches_on_slice18_paths"] = {"lm_production_autotuned": planned["lm"]["launches"][key]}

    # 28a-c. this slice: the elastic runtime, each path with the counters
    # zeroed just before it
    elastic = elastic_phases(device, all_counted)
    print(json.dumps({"elastic": elastic}), flush=True)
    ranks28 = elastic["two_ranks"]
    for k, key in ((conv_a, "compute_a_conv_fused"), (resnet_apply, "fused_precondition_stack"),
                   (resnet_sgd, "fused_sgd_apply")):
        k["launches_on_slice19_paths"] = {
            **{f"resnet32_{name}": n[key] for name, n in elastic["resnet32"]["launches"].items()},
            **{f"resnet32_two_ranks_{name}_per_rank": [r[key] for r in per]
               for name, per in ranks28["launches_per_rank"].items()},
            "resnet32_two_ranks_resumed_per_rank": [r[key] for r in
                                                    ranks28["resumed_launches_per_rank"]],
            **{f"resnet32_one_process_{name}": n[key]
               for name, n in ranks28["one_process_launches"].items()}}
    for k, key in ((token_count, "compute_a_embed_fused"), (lm_apply, "fused_precondition_stack"),
                   (lm_sgd, "fused_sgd_apply"), (flash[0], "flash_forward"),
                   (flash[1], "flash_backward_dq"), (flash[2], "flash_backward_dkv")):
        k["launches_on_slice19_paths"] = {
            **{f"lm_{name}": n.get(key, 0) for name, n in elastic["lm"]["launches"].items()},
            **{f"wikitext_lstm_{name}": n.get(key, 0)
               for name, n in elastic["lstm"]["launches"].items()}}

    # 29a-b. this slice: the curvature service, each path with the counters
    # zeroed just before it
    service = service_phases(device, all_counted, service_res)
    print(json.dumps({"service": service}), flush=True)
    two29 = service["two_ranks"]
    for k, key in ((conv_a, "compute_a_conv_fused"), (resnet_apply, "fused_precondition_stack"),
                   (resnet_sgd, "fused_sgd_apply")):
        k["launches_on_slice20_paths"] = {
            "resnet32_service_gate": service["gate"]["launches"][key],
            "resnet32_two_ranks_trainer": two29["resnet32"]["launches"][key]}
    for k, key in ((token_count, "compute_a_embed_fused"), (lm_apply, "fused_precondition_stack"),
                   (lm_sgd, "fused_sgd_apply"), (flash[0], "flash_forward"),
                   (flash[1], "flash_backward_dq"), (flash[2], "flash_backward_dkv")):
        k["launches_on_slice20_paths"] = {"lm_two_ranks_trainer": two29["lm"]["launches"][key]}

    mark("30. the compiled step")
    # 30. this slice: the CIFAR twin's step captured per variant in CUDA
    # graphs, against the eager step, the counters zeroed just before each
    compiled = compiled_step_phase(device, all_counted)
    print(json.dumps({"compiled_step": compiled}), flush=True)
    for k, key in ((conv_a, "compute_a_conv_fused"), (resnet_apply, "fused_precondition_stack"),
                   (resnet_sgd, "fused_sgd_apply")):
        k["launches_on_slice22_paths"] = {
            f"resnet32_{mode}": n[key] for mode, n in compiled["launches"].items()}

    mark("31a. the compiled step: the LM twin")
    # 31a-c. this slice: the LM and ImageNet twins' steps captured per
    # variant in CUDA graphs, against the eager step, the counters zeroed
    # just before each run
    twin_graphs = twin_compiled_step_phase(device, all_counted)
    print(json.dumps({"twin_compiled_steps": twin_graphs}), flush=True)
    for k, key in ((token_count, "compute_a_embed_fused"), (lm_apply, "fused_precondition_stack"),
                   (lm_sgd, "fused_sgd_apply"), (flash[0], "flash_forward"),
                   (flash[1], "flash_backward_dq"), (flash[2], "flash_backward_dkv"),
                   (rx_conv_a, "compute_a_conv_fused"),
                   (rx_conv_a_bf16, "compute_a_conv_fused:bf16"),
                   (grouped_a, "compute_a_conv_grouped_fused"),
                   (grouped_a_bf16, "compute_a_conv_grouped_fused:bf16"),
                   (rx_apply, "fused_precondition_stack"), (rx_sgd, "fused_sgd_apply")):
        k["launches_on_slice23_paths"] = {
            f"{path}_{name}_{mode}": n.get(key, 0)
            for path, runs in twin_graphs.items() for name, run in runs.items()
            if name != "capture_window" for mode, n in run["launches"].items()}

    mark("32. results")
    # 32. results: kernels 1, 2, 3 and 4 run on several paths; the top-level
    # numbers are those of the path named in "unit", the others sit beside
    conv_a[IMAGENET_MODEL] = rx_conv_a
    conv_a_bf16[IMAGENET_MODEL] = rx_conv_a_bf16
    lm_apply["resnet32"] = resnet_apply
    lm_apply[IMAGENET_MODEL] = rx_apply
    rx_apply_bf16["resnet32"] = resnet_apply_bf16
    rx_apply_bf16["lm"] = lm_apply_bf16
    lm_apply["wikitext_lstm_v1000"] = wt_rows["apply"]
    lm_apply["wikitext_lstm_v33278"] = wt_rows["apply_wide"]
    lm_sgd["resnet32"] = resnet_sgd
    lm_sgd[IMAGENET_MODEL] = rx_sgd
    lm_sgd["wikitext_lstm"] = wt_rows["sgd"]
    conv_a[f"{SHARD_MODEL}_shards"] = rn50_conv_a
    token_count["wikitext_tied"] = wt_rows["token_count"]
    kernels = [conv_a, conv_a_bf16, grouped_a, grouped_a_bf16, token_count, moe_dispatch,
               lm_apply, rx_apply_bf16, lm_sgd, sgd_3d, *flash]
    print(json.dumps({"phase_seconds": phase_seconds()}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
