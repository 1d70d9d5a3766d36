"""Smoke run of paddle_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py [--parent DIR] [--parent-engine ROOT]

Builds the port's CUDA kernels from ``paddle_tpu_torch/ops/csrc`` and drives
the port's main paths — the paged continuous-batching LLaMA server with a
bf16 KV cache, and with an int8 KV cache and speculative decoding, at the
full width of LLaMA-2 7B; the train step of the repo's 271M LLaMA at
B 8 x S 2048; ERNIE-3.0-base MLM training at B 64 x S 512 at its published
dropout 0.1; its sequence-classification fine-tuning at B 32 x S 128; the
``nn.functional.softmax`` entry; ViT-L/16 training at 384 px (577
tokens, which attention pads to the 128 tile) and at 224 px; the
SD-1.5 UNet's train step at B 8 over 64 x 64 latents; and ResNet-50
training at B 256 over 224 x 224 images with the BatchNorms in training
mode, and MobileNet V1 / V2 / V3-Large — with random weights made from a
seed:

  1. build     nvcc for every kernel source, all started together, and
               ptxas's registers and spills of the mma.sync dK/dV and of
               the wgmma forward, dK/dV and dQ, the RMSNorm
               and LayerNorm register passes, the ragged paged-attention
               kernels and the softmax forward's register pass (the
               wgmma bodies, the ragged kernels and the register passes of
               the softmax forward, the RMSNorm forward and the LayerNorm
               backward must not spill; no flash-attention kernel may
               carry ptxas's C7520, a serialised wgmma), and the SASS that
               the dropout branch adds to the wgmma forward and dQ
               (``cuobjdump``; instructions per Philox call; the wgmma
               dK/dV's in phase 5e); the flash-attention kernels build as
               one library per group of head widths (``flash_attention.cu``
               at 64 and 128, and at each of 32, 48, 80, 96, 160, 192, 256
               with ``-DFA_TU_WIDTHS=W``), each reported and held to the
               same no-spill gate, and with ``--parent DIR`` that build's
               flash-attention libraries are built beside them;
  2. kernel    both kernels against their plain PyTorch version on the
               card: 7B decode (kv_len 0/5/16/1024/..), a 256-token prefill
               chunk over a cached prefix, GQA 16:4 at D = 64 / page 64, a
               ragged q_len 0/1/3/5 mix (the verify shape), one split (a
               4-page table), GQA 16:4 decode over 1-page splits, a 37-row
               chunk with a q_len = 0 slot, and at the split length L of
               the wrapper's plan kv_len 1 / L - 1 / L / L + 1 / 0 and
               verify rows whose frontier crosses or falls inside a split;
               f32 and bf16 inputs, bf16 and f32 outputs; the quantized
               kernel over int8 and fp8 pages, its fp8 -> f32 code table
               against torch's over all 256 codes, and the split merge
               against its plain version;
               (b) the body every launch of rows 3/5/6 takes, at every
               width (bf16 forward, dK/dV and dQ wgmma, with or without
               dropout, but dK/dV without segments at W 160 mma.sync; f32
               the CUDA cores), and the forward's design (q rows a block,
               keys a tile, persistent grid) at the phase-3 launches and
               S 200, as the dispatch reports it (the segment branch a
               block per q tile, a persistent grid only over more q tiles
               than SMs); the train kernels (flash-attention forward with its
               lse, the lse repack, the dK/dV and dQ backward, RMSNorm
               forward and backward) against their plain versions: the
               train shape
               (bf16, causal), GQA 16:4 at D = 128, f32, s_q < s_k causal
               and not, lengths of 200 (partial tiles) causal and not, f32
               and bf16; for the bf16 kernels' own tiling, s_q < s_k
               causal, GQA 16:4 at S 320 (a partial 128-row q tile), S 200
               causal at D = 128 and one 64-row q tile against 2,048 keys;
               for dQ's 64-row blocks, D = 128 with GQA 16:4, a q length
               of 136, s_q < s_k causal with GQA 16:4 and S 200
               non-causal; GQA 8:2 at S 200 causal; GQA 4:1 over 288
               q tiles (the forward's persistent grids, 128-key tiles at
               D 64 and 64-key tiles at D 96 off the tile); the standalone
               repack on strided stats, RMSNorm
               rows at 16,384 x 1,024 bf16 and f32, N off the backward's
               row runs with f32 w, H = 768, N = 5, H = 1,000 and 4,096
               (the general loops) and f32 x with bf16 w;
               (c) the LayerNorm kernels at ERNIE's 32,768 x 768 rows, bf16
               and f32, at H 1,024, N 32,771 with f32 w, N 5, H 1,000 and
               4,096 (the backward's general loop) and bf16 x with f32 w,
               with the f32 dw / db sums' distance from a float64 sum
               beside torch.sum's; the softmax and AdamW kernels at ERNIE's
               shapes ([8, 12, 512, 512]; the 40,000 x 768 embedding and
               tensors of 768 and 40,000), bf16 and f32,
               the softmax forward's register pass at 2,048 and its looped
               kernel at 4,096 and 1,002 (and rows of -inf throughout),
               and the flash-attention kernels non-causal at ERNIE's
               attention shape; their dropout branch at rate 0.1 against
               the plain versions under the same seed (ERNIE's shape, bf16
               and f32, D 64 and 128, causal and not, GQA 8:2, s_k off the
               tile, s_q < s_k, S 200 causal, GQA 4:1 on the forward's
               persistent grids), and the masks of o, dQ, dK and dV read
               out through one-hot inputs (bf16 and f32, D 64 and 128,
               bf16 at D 40, 160 and 192, and on the forward's persistent
               grids at D 64 and 80 with GQA 4:1, lengths off the tile):
               every bit equal to
               ``dropout_keep``, causal and not, and the keep rate over
               10.5M scores within 5 sigma of 0.9;
               (d) every bf16 segment launch of rows 3/5/6 takes a wgmma
               body (the library's dispatch, at every width of (e) and
               with and without dropout); their segment branch (the
               varlen mask, and the padding of an untileable sequence,
               which takes a segment of its own) against the plain
               versions: bf16 and f32, D 64 and
               128, causal and not, GQA 8:2, boundaries on and off the
               64 / 128 tiles (the JAX suite's [0]*100 + [1]*156, a
               segment inside one tile), packed rows of segments of
               5..300, the op's pad-to-tile inputs at S 390, 453 and 577,
               and at dropout 0.1; the masks read out with segments (no
               kept score outside its segment); and the op's pad path at
               S 577 end to end, f32, against ``flash_attention_ref``;
               cases aimed at the wgmma bodies' tile classes: segments on
               the 64-row tiles (whole tiles skipped), a segment inside
               one tile, ids out of order and ids that recur, GQA 8:2
               causal, dropout 0.1 and a mask read-out over them;
               (e) rows 3/5/6 at head dims 24, 40, 56, 72, 80, 96, 112,
               160, 176, 200 and 256 (every compiled width, off-width dims
               included), bf16 and f32, causal and not, GQA 8:2 at 40 / 80
               / 160, and at each a bf16 segment case, a bf16 GQA 8:2 case
               at S 200 and bf16 dropout cases causal and not with the
               masks read out (the wgmma bodies at every width), and their dropout and
               segment branches at 40 and 160 in f32 too, and bf16 non-causal at the UNet's three attention
               shapes (phase 3h's B 8, 8 heads; S 4,096 / 1,024 / 256 at
               d 40 / 80 / 160); rows 1-2 at head dims 40, 80, 96 and 256
               over bf16, f32, int8 and fp8 pages (decode with a split,
               verify with GQA, a prefill chunk); rows 12/13 at the UNet's
               LayerNorm rows (8,192 x 640, 2,048 x 1,280) are phase 2c's;
  3. serving   (a) a bf16 ServingEngine at 7B widths serves 8 requests in
               4 slots: chunked prefill, a prefix-cache hit served by a
               suffix prefill, greedy decode, each decode horizon a replay
               of a captured CUDA graph; the plain kernel's launch
               counter (graph replays included) must cover every layer of
               every decode step and the plain version must not run; then
               a decode step's wall time against its kernels' device time,
               and the host's launch calls per step (torch.profiler);
               (a') the same traffic through an overlap=True engine (the
               double-buffered host loop): the same measures, and greedy
               streams equal to (a)'s; (a'') the traffic again through
               both engines in turns (sync, overlap, overlap, sync);
               (b) the same 7B model with kv_dtype="int8" and
               speculative=4, its pool the same KV bytes as (a), serves
               traffic whose prompts repeat a segment, verify steps as
               graph replays too: the quantized kernel's launches must
               equal layers x attention dispatches (decode steps + verify
               steps + prefill chunks), the plain kernel and the plain
               version must not run, and drafts must be proposed and
               verified;
               (i) the request lifecycle on (b)'s successor weights, two
               overlap=True engines sharing them: a snapshot taken with a
               dispatch in flight restores into the second engine and
               continues, a mid-decode request moves by export_kv /
               import_kv, a cancel and a timeout=0.0 act with a dispatch in
               flight; every stream on the model's greedy path, the page
               accounting exact, every page back, no pool tensor moved;
               (k) the engine's telemetry, fault points and durable
               snapshots on the same weights at 3a's geometry: 3a's traffic
               through telemetry-off and telemetry-on engines, with and
               without overlap — the same streams (the greedy path), the
               same ``jit_variants()`` and the same synchronising calls
               (``torch.cuda.set_sync_debug_mode("warn")``), tokens/s in
               turns, TTFT / TPOT from the histograms, the utilization
               shares, peak occupancy and the captures; on an int8-KV
               engine a seeded ``serve.pool_pressure`` plan (the ladder
               submit -> admit -> evict -> preempt, every page back), a
               ``pagepool.alloc`` trigger and a wedged step; on an
               overlap=True engine a full-KV ``save_engine`` with a
               dispatch in flight, a save torn by ``serve.snapshot`` and one
               killed by ``ckpt.commit`` (the first stays the newest intact
               snapshot), a ``serve.crash`` raise whose flight dump goes to
               a file, and a fresh engine restored through
               ``restore_engine`` continuing every stream; the profiler
               bridge's ``serve.decode_dispatch`` spans around the decode
               graph launches in a torch.profiler trace; the phase's
               launches of rows 1-2;
               with ``--parent-engine ROOT`` another commit's (a) and (b)
               run in a process of their own before (a) and after (k);
               (c) the 271M LLaMA train step (bf16, B 8, S 2048,
               head_chunks 8, AdamW): 3 warm-up and 10 timed steps, the
               loss of each (finite and falling: labels equal the inputs),
               tokens/s, the mfu share, peak memory, launches per step of
               each train kernel (asserted), one step under torch.profiler;
               (d) ERNIE-3.0-base MLM training (bf16, f32 moments, B 64,
               S 512, dropout 0.1 on both probabilities) with flash
               attention and its in-kernel dropout, the LayerNorm kernels
               and the fused AdamW: the same measures, launches per step of
               rows 3/5/6/9/12/13 and of the dropout branch of rows 3/5/6
               asserted, no plain version run; then the same step at
               dropout 0 (5 timed steps), for the cost of dropout;
               (f) ERNIE-3.0-base sequence classification (2 classes,
               bf16, B 32, S 128, dropout 0.1, fused AdamW lr 2e-5, random
               ids and labels): a few steps, finite losses, launches per
               step asserted;
               (e) nn.functional.softmax through the softmax kernels,
               forward and backward, and the shapes that take the plain op;
               (g) ViT-L/16 training at 384 px (bf16, f32 moments, B 32,
               full width and depth, fused AdamW, random images and labels
               on one fixed batch): 3 warm-up and 10 timed steps, images/s,
               the mfu share, peak memory, launches per step asserted (the
               segment branch of rows 3/5/6 once per layer through the pad
               path, rows 12/13 per norm, row 9 per tensor, no plain
               version), the body each segment launch ran
               (``kernel_body``) and one step under torch.profiler; (g')
               the same at 224 px, B 64 (197 tokens: no flash-attention
               kernel, the plain path once per layer, as the JAX dispatch
               sends it);
               (h) the SD-1.5 UNet train step (bf16, B 8, 4 x 64 x 64
               latents, a 77 x 768 context, MSE against the noise, SGD lr
               1e-4, as bench.py's bench_sd_unet): 3 warm-up and 10 timed
               steps on one batch, images/s, the mfu share (unet_flop),
               peak memory, launches per step asserted (rows 3/5/6 four
               times at each of head dims 40 / 80 / 160, rows 12/13 at
               widths 640 and 1,280; plain attention for the
               cross-attentions and the 8 x 8 middle block, the plain
               LayerNorm at width 320), the body each launch ran per head
               dim, the forward / backward / SGD split and one step under
               torch.profiler;
               (j) ResNet-50 training (``resnet50``, 1,000 classes, bf16
               parameters, f32 velocity, B 256, 224 x 224, NCHW, the
               BatchNorms in training mode, Momentum 0.9 at lr 0.1 with L2
               decay 1e-4 as PaddleClas's ResNet50.yaml, the loss as
               bench.py's bench_resnet50): 3 warm-up and 10 timed steps on
               one batch, the loss of each (finite and falling), every
               running buffer moved, no kernel of the port launched and no
               plain version called, images/s, the mfu share (6 x the
               forward's multiply-adds, ``vision_macs``: 4.089 G an image,
               checked), peak memory, the forward / backward / Momentum
               split and the device ms by op group (convolution, batch
               norm, pooling, matmul, Momentum, other); (j') MobileNet V1,
               V2 and V3-Large the same way, two steps each, images/s of
               the second;
  4. engine    a 2-layer f32 engine at 7B widths with margin-engineered
               weights gives the same greedy tokens with the kernel as with
               the plain version, and with overlap=True, for f32, int8 and
               fp8 pages, and with speculative=4 as without (also with
               overlap=True); (b) one f32 train step at full
               width and 2 layers gives the same loss, gradients and
               updated parameters with the kernels as with the plain
               versions; (c) the same for a 2-layer f32 ERNIE step at
               dropout 0, and at dropout 0.1 the kernels against the same
               step with rows 3/5/6 replaced by their plain versions (the
               same seeds and generator states); (d) the same for a 2-layer
               f32 ViT-L/16 step at 384 px, kernels against all knobs off;
               (e) one f32 SD-1.5 UNet step at full width, B 1, both knobs
               on against off: loss to 1e-5, gradients to 1e-4 of max
               |grad|; (f) one ResNet-50 step at full width and depth, B 2,
               64 x 64, on the card against the CPU from the same weights,
               TF32 off: with eval-mode BatchNorm in f32 the loss to 1e-5,
               every gradient to 1e-4 of max |grad| and every updated
               parameter to 1e-4 of its largest update (plus one ulp);
               with training-mode BatchNorm in f64 the loss to 1e-5, every
               gradient to 1e-4 of max |grad|, the running buffers to 1e-5
               and the updated parameters to 1e-6, and the card's f32
               step within 1e-4 of the CPU's f64 (loss and buffers), with
               the f32 and TF32 gaps printed;
  5. timing    each kernel, its plain version and the bound (bytes over
               3.35 TB/s, operations over 989 TFLOP/s bf16) at the decode,
               verify and chunk shapes of phase 3 (rows 1-2 as CUDA-graph
               replays, the eager time on its own line), the split merge
               alone, one line per design step of rows 1-2 (split count,
               ring depth, warps, the tensor-core tile's row threshold),
               with ``--parent DIR`` that
               build's rows 1, 2 and 10 timed in turns with these, the
               train kernels at
               the phase-3c shape beside SDPA (forward; backward alone, and
               forward + backward), F.rms_norm and
               aten._fused_rms_norm_backward, rows 3, 5 and 6 at
               phase 3d's attention shape at rate 0 and at dropout 0.1
               (beside SDPA with dropout_p=0.1; the bound counts the mask's
               Philox work; with ``--parent DIR`` that build's rows 3d,
               5d and 6d in turns with these), one line per design step of
               the wgmma forward (``FWD_VARIANTS``: 64 or 128 keys a
               tile, a block per q tile or a persistent grid; each held
               against the plain version and timed at
               3c's, 3d's, 3h's and ViT's shapes), with ``--parent DIR``
               (another commit's ``csrc``) that build's rows 3, 5 and 6 at
               rate 0 (the train shape, CUDA-graph replays), its forward at
               3d's shape and at the widths no model takes, the 3c and 3d
               steps on its flash-attention library, RMSNorm forward and
               LayerNorm backward timed in turns with these on rotated
               inputs, and the LayerNorm,
               softmax and AdamW kernels at the phase-3d/3e shapes beside
               F.layer_norm, aten.native_layer_norm_backward, torch.softmax,
               aten._softmax_backward_data and torch._fused_adamw_ (the
               backward-only calls held against the plain version first;
               the forward + backward through autograd printed beside
               them); (d) the segment branch of rows 3, 5 and 6 at
               phase 3g's attention shape (577 rows padded to 640) beside
               SDPA on the unpadded inputs, and at a packed varlen shape
               beside SDPA with the block-diagonal mask, the bounds counting
               the function's (unpadded, in-segment) work, the wgmma bodies'
               skip / full / masked tile counts (``segment_tile_plan`` at
               each body's tiles: the forward's, dK/dV's and dQ's), the
               kernels as CUDA-graph replays, with ``--parent DIR`` that
               build's rows 3s, 5s and 6s in turns with these at both
               shapes; (e) rows 3/5/6 at the UNet's
               three attention shapes ([8, S, 8, d], (S, d) = (4,096, 40),
               (1,024, 80), (256, 160), non-causal) beside the bound
               counted at d, the plain version and SDPA's forward and
               backward (the kernels and SDPA alike as CUDA-graph replays
               over input copies that together exceed the L2), with
               ``--parent DIR`` that build's rows 3/5/6 in turns with these
               and the 3h step on its libraries in turns with this one's,
               one line per design step of the wgmma dK/dV and dQ (dK/dV's
               ring depth, q tile and pipelining, dQ's ring depth, at 3c's
               and the UNet's level-0 shapes, and at 3d's at dropout 0.1)
               the SASS that dropout adds to the wgmma dK/dV, and of
               dK/dV above W 128 (mma.sync against the wgmma body, at rate
               0 and at dropout 0.1), and rows 1-2 at head dim
               80 at phase 3a's decode shape beside their byte bound;
  6. summary   the card's name and power limit, a ``kernels`` JSON line and
               the result line.

Any failed check raises and exits non-zero; so does a machine with no CUDA
device, or a directory without the package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
F32_FLOP_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
# 32-bit integer operations: the 67 TFLOP/s above is 132 SMs x 128 f32
# lanes x 2 (an FMA) x 1.98 GHz, and an SM has 64 INT32 lanes of its 128
INT32_OP_PER_S = 132 * 64 * 1.98e9
# what one Philox4x32-10 call (4 mask words) needs: 10 rounds of 2 wide
# 32 x 32 -> 64-bit multiplies (one IMAD.WIDE.U32 each gives the hi and lo
# words) and 2 three-input xors (one LOP3 each); the key schedule is the
# same for every call of a launch and is left out
PHILOX_OPS = 40
ERNIE_BASE_PARAMS = 149_294_656    # ERNIE-3.0-base, 205 tensors
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# quantized pages at bf16: the plain version rounds each dequantized K/V row
# to bf16 before attending (as the JAX reference does) and the kernel keeps
# it in f32, so the two differ by that rounding (2**-9 relative per
# element) on top of the bf16 output rounding
TOL_QUANT_BF16 = (2e-2, 2e-2)
CSRC = "paddle_tpu_torch/ops/csrc/"
PLAIN = dict(name="ragged_paged_attention", route="cuda",
             source=CSRC + "ragged_paged_attention.cu",
             replaces="paddle_tpu/ops/pallas/paged_attention.py:124")
QUANT = dict(name="ragged_paged_attention_quant", route="cuda",
             source=CSRC + "ragged_paged_attention_quant.cu",
             replaces="paddle_tpu/ops/pallas/paged_attention.py:147")
# the split merge that follows rows 1-2 when a launch's plan splits its KV
# range; the TPU kernel carries its running softmax across the page grid
# axis instead, so the merge replaces that carry
COMBINE = dict(name="ragged_paged_attention_combine", route="cuda",
               source=CSRC + "ragged_paged_attention.cuh",
               replaces="paddle_tpu/ops/pallas/paged_attention.py:124")
KV_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# -- phase 1: build ----------------------------------------------------------
REPORTED_KERNELS = ("fa_bwd_dkv_mma_kernel",
                    "rms_fwd_vec_kernel", "rms_bwd_vec_kernel",
                    "ln_bwd_vec_kernel", "ragged_paged_attention_kernel",
                    "ragged_paged_attention_mma_kernel",
                    "ragged_paged_attention_combine_kernel",
                    "softmax_fwd_reg_kernel", "fa_fwd_wgmma_kernel",
                    "fa_bwd_dkv_wgmma_kernel", "fa_bwd_dq_wgmma_kernel")
# kernels that hold their working set in registers by design: none may spill
# (the wgmma bodies at every width: their accumulators and pipelined score
# tiles fill the consumers' 232 registers)
NO_SPILL = ("ragged_paged_attention_kernel",
            "ragged_paged_attention_mma_kernel",
            "ragged_paged_attention_combine_kernel", "softmax_fwd_reg_kernel",
            "rms_fwd_vec_kernel", "ln_bwd_vec_kernel", "fa_fwd_wgmma_kernel",
            "fa_bwd_dkv_wgmma_kernel", "fa_bwd_dq_wgmma_kernel")
# the tensor-core flash-attention bodies whose dropout instantiations have
# their DROP = false twins, of the same structure, in the W 64 / 128
# library; the wgmma dK/dV's twin there is pipelined and its dropout branch
# is not, so its SASS is compared in phase 5e, in the unpipelined build
DROP_TWINS = ("fa_fwd_wgmma_kernel", "fa_bwd_dq_wgmma_kernel")


def ptxas_lines(path, kernels=REPORTED_KERNELS):
    """(kernel, template arguments as mangled, registers, spill stores,
    spill loads) of every instantiation of ``kernels`` in the ptxas report
    kept beside the library at ``path``."""
    import re
    entry = re.compile(
        r"Compiling entry function '(\w+)'[^\n]*\n[^\n]*\n\s*(\d+) bytes "
        r"stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n"
        r"[^\n]*Used (\d+) registers")
    out = []
    for mangled, _, stores, loads, regs in entry.findall(
            path.with_suffix(".log").read_text()):
        kernel = next((k for k in kernels if k in mangled), None)
        if kernel is not None:
            args = mangled[mangled.index(kernel) + len(kernel):]
            out.append((kernel, args.split("EEv")[0] + "E", int(regs),
                        int(stores), int(loads)))
    return out


def sass_opcodes(path):
    """{mangled kernel name: Counter of its SASS opcodes} of the library at
    ``path``, from ``cuobjdump -sass`` (the toolkit's, beside nvcc)."""
    import collections
    import re
    from pathlib import Path
    from paddle_tpu_torch.ops import _build
    dump = subprocess.run(
        [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
         str(path)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")
    out, cur = {}, None
    for line in dump.splitlines():
        if "Function : " in line:
            cur = out.setdefault(line.split("Function : ")[1].strip(),
                                 collections.Counter())
        elif cur is not None and (m := op.search(line)):
            cur[m.group(1)] += 1
    return out


def philox_sass_report(path, kernels=DROP_TWINS):
    """What the dropout branch adds to each tensor-core flash-attention
    kernel of ``kernels``, as compiled: the SASS of every DROP = true
    instantiation less its DROP = false twin, opcode by opcode.  Every mask
    word meets one unsigned compare with the threshold (ISETP.GE.U32), so
    the compares it adds over the 4 words of a Philox4x32-10 call give the
    calls in the code, and the added instructions over those calls the
    instructions per call (the bound counts ``PHILOX_OPS`` of them)."""
    ops = sass_opcodes(path)
    for mangled, drop in sorted(ops.items()):
        kernel = next((k for k in kernels if k in mangled), None)
        if kernel is None or "Lb1EEEv" not in mangled:
            continue
        base = ops.get(mangled.replace("Lb1EEEv", "Lb0EEEv"))
        require(base is not None, f"no DROP = false twin of {mangled}")
        delta = {o: drop[o] - base[o] for o in drop | base
                 if drop[o] != base[o]}
        calls = sum(n for o, n in delta.items()
                    if o.startswith("ISETP.GE.U32")) / 4
        added = sum(delta.values())
        top = ", ".join(f"{o} {n:+d}" for o, n in sorted(
            delta.items(), key=lambda x: -abs(x[1]))[:8])
        args = mangled[mangled.index(kernel) + len(kernel):].split("EEEv")[0]
        per_call = f"{added / calls:.1f}" if calls else "n/a"
        print(f"  SASS {kernel}{args}E: dropout adds {added:+d} instructions "
              f"({sum(base.values())} -> {sum(drop.values())}); {calls:g} "
              f"Philox calls in the code, {per_call} instructions per call; "
              f"{top}")


def fa_libs(built):
    """The flash-attention libraries (one per group of head widths)."""
    return sorted(n for n in built if n.startswith("flash_attention"))


def rpa_libs(built):
    """The ragged paged-attention libraries (f32 / bf16 and int8 / fp8
    pages, one per group of head widths)."""
    return sorted(n for n in built if n.startswith("ragged_paged_attention"))


def register_report(built, parent=None):
    """ptxas's registers and spills for the flash-attention kernels at every
    head width, the RMSNorm forward and backward register passes, the
    LayerNorm backward's register pass, the ragged paged-attention kernels
    and the softmax forward's register pass (one line per instantiation;
    the ragged kernels' as their most); the kernels of ``NO_SPILL`` must
    not spill.  With ``parent`` (another commit's ``csrc``), that build's
    flash-attention libraries are built too (``build_parent``)."""
    for lib in (*fa_libs(built), "rms_norm", "layer_norm", "softmax"):
        for kernel, args, regs, stores, loads in ptxas_lines(built[lib]):
            print(f"  ptxas {kernel}{args}: {regs} registers, spill "
                  f"stores {stores} B, loads {loads} B")
    print(f"  ptxas ragged paged attention: {ragged_ptxas(built)}")
    philox_sass_report(built["flash_attention"])
    for lib in (*fa_libs(built), "rms_norm", "layer_norm", "softmax",
                *rpa_libs(built)):
        for kernel, args, regs, stores, loads in ptxas_lines(built[lib]):
            require(kernel not in NO_SPILL or (stores == 0 and loads == 0),
                    f"{kernel}{args} spills ({stores} B stores)")
    serialised_wgmma(built)
    if parent is not None:
        build_parent(parent)


def serialised_wgmma(built):
    """ptxas's C7520 warnings in the flash-attention libraries' reports: a
    wgmma that the compiler serialises (one issued on a divergent path
    makes it serialise every wgmma of the kernel).  Each is printed, and
    any fails the build."""
    import re
    found = []
    for lib in fa_libs(built):
        for line in built[lib].with_suffix(".log").read_text().splitlines():
            if "C7520" in line:
                m = re.search(r"function '(\w+)'", line)
                found.append(f"{lib}: {m.group(1) if m else line.strip()}")
    for f in found:
        print(f"  ptxas C7520 (serialised wgmma) in {f}")
    require(not found, f"{len(found)} kernels with serialised wgmma (C7520)")
    print(f"  no serialised wgmma (ptxas C7520) in {len(fa_libs(built))} "
          f"flash-attention libraries")


def template_args(args):
    """The integer and bool template arguments of a mangled instantiation,
    in order (``ILi64ELb0E...`` -> [64, 0, ...])."""
    import re
    return [int(x) for x in re.findall(r"L[ib](\d+)E", args)]


def build_parent(parent):
    """Every flash-attention library of another commit's ``csrc``
    (``parent``), one ``nvcc`` each, all started together, for the turns
    of phases 5b-5e; prints the seconds they took and the registers and
    spills of that build's bf16 forward at each width (``fa_fwd_mma_kernel``
    or ``fa_fwd_wgmma_kernel``, whichever it has)."""
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    names = sorted(n for n in _build._sources(Path(parent))
                   if n.startswith("flash_attention"))
    paths = _build.build_all(names, csrc=Path(parent))
    print(f"  built the parent's {names} in {time.perf_counter() - t0:.1f} s")
    for name in names:
        for kernel, args, regs, stores, _ in ptxas_lines(
                paths[name], ("fa_fwd_mma_kernel", "fa_fwd_wgmma_kernel")):
            print(f"  ptxas parent {kernel}{args}: {regs} registers, spill "
                  f"stores {stores} B")


# -- phase 2: the kernel against its plain version ---------------------------
def make_case(gen, S, Qmax, Hq, Hkv, D, ps, NP, P, q_start, q_len, kv_len,
              dtype):
    dev = "cuda"
    q = torch.randn(S, Qmax, Hq, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(Hkv, NP, ps, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(Hkv, NP, ps, D, generator=gen, device=dev).to(dtype)
    pt = torch.randint(0, NP, (S, P), generator=gen, device=dev,
                       dtype=torch.int32)
    seg = [torch.tensor(x, dtype=torch.int32, device=dev)
           for x in (q_start, q_len, kv_len)]
    return q, k, v, pt, *seg


def train_wrappers():
    """Rows 3-13's wrappers, each with its ``launches`` count, by key."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused as fu
    return {"fa_fwd": fa.flash_attention_fwd, "pack_lse": fa.pack_lse,
            "fa_dkv": fa.flash_attention_bwd_dkv,
            "fa_dq": fa.flash_attention_bwd_dq,
            "rms_fwd": fu.rms_norm_fwd, "rms_bwd": fu.rms_norm_bwd,
            "adamw": fu.adamw_update, "softmax_fwd": fu.softmax_fwd,
            "softmax_bwd": fu.softmax_bwd, "ln_fwd": fu.layer_norm_fwd,
            "ln_bwd": fu.layer_norm_bwd}


def reset_counts(pa):
    """Every kernel's launch count (rows 1-13, and the dropout and segment
    launches of rows 3/5/6) and the paged plain version's call count to
    0."""
    pa.ragged_paged_attention.launches = 0
    pa.ragged_paged_attention.quant_launches = 0
    pa.ragged_paged_attention.combine_launches = 0
    pa.ragged_paged_attention_ref.calls = 0
    for fn in train_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "dropout_launches"):
            fn.dropout_launches = fn.segment_launches = 0


def branch_counts():
    """The dropout and the segment launches of rows 3/5/6, by the dropout
    and segment rows' keys."""
    w = train_wrappers()
    out = {key: w[key.removesuffix("_drop")].dropout_launches
           for key in DROP_KEYS}
    out.update({key: w[key.removesuffix("_seg")].segment_launches
                for key in SEG_KEYS})
    return out


class CountPlainCalls:
    """Within the block, count every call of the plain versions a train
    path could fall back to — each kernel's ``*_ref`` and the plain ops
    (``layer_norm_ref``, ``_sdpa_ref``, ``torch.softmax`` through the
    functional ``softmax``) — by wrapping them where the port looks them up;
    ``calls`` holds the count by name."""

    def __init__(self):
        from paddle_tpu_torch.nn.functional import attention, norm
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import fused as fu
        self.sites = [(m, n) for m in (fa, fu) for n in dir(m)
                      if n.endswith("_ref")]
        self.sites += [(norm, "layer_norm_ref"), (attention, "_sdpa_ref")]
        self.calls = {}

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n in self.sites]
        for m, n, fn in self.saved:
            def counted(*a, _fn=fn, _n=n, **kw):
                self.calls[_n] = self.calls.get(_n, 0) + 1
                return _fn(*a, **kw)
            setattr(m, n, counted)
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def counts(pa):
    return (pa.ragged_paged_attention.launches,
            pa.ragged_paged_attention.quant_launches,
            pa.ragged_paged_attention_ref.calls)


def quantize_pages(args, kv_dtype):
    """The case's f32/bf16 pages as int8 / fp8 codes + per-row scales."""
    from paddle_tpu_torch.serving.quant import kv_spec, quantize_kv
    dt, qmax = kv_spec(kv_dtype)
    (kq, ks), (vq, vs) = (quantize_kv(p, qmax=qmax, dtype=dt)
                          for p in args[1:3])
    return (args[0], kq, vq, *args[3:]), dict(k_scales=ks, v_scales=vs)


def compare(pa, name, args, out_dtype, **scales):
    got = pa.ragged_paged_attention(*args, out_dtype=out_dtype, **scales)
    want = pa.ragged_paged_attention_ref(*args, out_dtype=out_dtype,
                                         **scales)
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    atol, rtol = TOL_QUANT_BF16 if scales and args[0].dtype == torch.bfloat16 \
        else TOL[out_dtype]
    err = (got - want).abs()
    max_err = err.max().item()
    require(bool((err <= atol + rtol * want.abs()).all()),
            f"{name}: kernel vs plain max abs err {max_err:.3e} "
            f"(atol {atol}, rtol {rtol})")
    q_len = args[5].long()
    pad = torch.arange(got.shape[1], device="cuda")[None, :] >= q_len[:, None]
    require(bool((got[pad] == 0).all()),
            f"{name}: padding rows / q_len=0 slots not exactly zero")
    print(f"  {name:<44} out={str(out_dtype)[6:]:<8} max_abs_err="
          f"{max_err:.3e} (tol {atol:g} + {rtol:g}*|ref|)")
    return max_err


KERNEL_CASES = [
        ("7B decode S=8 ps=16 kv_len 0/5/16/1024/..",
         dict(S=8, Qmax=1, Hq=32, Hkv=32, D=128, ps=16, NP=600, P=64,
              q_start=[0, 4, 15, 1023, 299, 16, 0, 776],
              q_len=[0, 1, 1, 1, 1, 1, 1, 1],
              kv_len=[0, 5, 16, 1024, 300, 17, 1, 777])),
        ("7B prefill chunk Qmax=256 over 256 cached",
         dict(S=1, Qmax=256, Hq=32, Hkv=32, D=128, ps=16, NP=64, P=40,
              q_start=[256], q_len=[256], kv_len=[512])),
        ("GQA 16:4 D=64 ps=64",
         dict(S=3, Qmax=8, Hq=16, Hkv=4, D=64, ps=64, NP=9, P=4,
              q_start=[0, 60, 130], q_len=[8, 1, 5], kv_len=[8, 61, 135])),
        ("ragged multi-query q_len 0/1/3/5 (verify)",
         dict(S=4, Qmax=5, Hq=32, Hkv=32, D=128, ps=16, NP=20, P=8,
              q_start=[10, 100, 63, 0], q_len=[0, 1, 3, 5],
              kv_len=[10, 101, 66, 5])),
        ("one split: a 4-page table, no combine",
         dict(S=3, Qmax=1, Hq=32, Hkv=32, D=128, ps=16, NP=16, P=4,
              q_start=[63, 29, 0], q_len=[1, 1, 1], kv_len=[64, 30, 1])),
        ("GQA 16:4 D=64 ps=64 decode, 1-page splits",
         dict(S=3, Qmax=1, Hq=16, Hkv=4, D=64, ps=64, NP=20, P=6,
              q_start=[299, 63, 64], q_len=[1, 1, 1], kv_len=[300, 64, 65])),
        ("chunk of 37 rows (not a multiple of 16), q_len 0 slot",
         dict(S=2, Qmax=40, Hq=32, Hkv=32, D=128, ps=16, NP=40, P=12,
              q_start=[100, 0], q_len=[37, 0], kv_len=[137, 0])),
]
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32))


def split_cases(pa):
    """Cases at the split grid's edges, their lengths taken from the split
    length L that the wrapper's plan gives their shapes on this card: decode
    kv_len 1, L - 1, L, L + 1 with a kv_len = 0 slot, and verify rows whose
    causal frontier crosses a split boundary or falls inside a split."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dec = dict(S=5, Qmax=1, Hq=32, Hkv=32, D=128, ps=16, NP=160, P=24)
    L = pa.split_plan(dec["S"], 1, 32, 32, 128, dec["P"], 16, True,
                      sms=sms).split_len
    ver = dict(S=4, Qmax=5, Hq=32, Hkv=32, D=128, ps=16, NP=120, P=24)
    V = pa.split_plan(ver["S"], 5, 32, 32, 128, ver["P"], 16, True,
                      sms=sms).split_len
    require(L < 24 * 16 and V < 24 * 16, f"split cases: splits of {L} / {V} "
            f"tokens leave one split")
    return [
        (f"split edges kv_len 1/L-1/L/L+1/0 (L={L})",
         dict(dec, q_start=[0, L - 2, L - 1, L, 0], q_len=[1, 1, 1, 1, 0],
              kv_len=[1, L - 1, L, L + 1, 0])),
        (f"verify frontier across / inside a split (L={V})",
         dict(ver, q_start=[V - 2, V - 5, V + V // 2, 0], q_len=[5, 5, 5, 0],
              kv_len=[V + 3, V, V + V // 2 + 5, 7])),
    ]


def phase_kernel(pa):
    """Both kernels against the plain version, and the split merge against
    its plain version on random partials; returns the worst absolute error
    of each."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"plain": 0.0, "quant": 0.0}
    n0 = pa.ragged_paged_attention.combine_launches
    for name, kw in KERNEL_CASES + split_cases(pa):
        for dtype, out_dtype in DTYPE_PAIRS:
            args = make_case(gen, dtype=dtype, **kw)
            err = compare(pa, f"{name} [{str(dtype)[6:]}]", args, out_dtype)
            worst["plain"] = max(worst["plain"], err)
            for kv_dtype in KV_DTYPES:
                qargs, scales = quantize_pages(args, kv_dtype)
                err = compare(pa, f"{name} [{str(dtype)[6:]}, {kv_dtype}]",
                              qargs, out_dtype, **scales)
                worst["quant"] = max(worst["quant"], err)
    require(pa.ragged_paged_attention.combine_launches > n0,
            "no case ran a split grid")
    fp8_code_table(pa)
    worst["combine"] = combine_check(pa, gen)
    return worst


def random_partials(gen, n, S, hkv, rows, d, live):
    """Split partials as the main kernel leaves them: m (base 2) and l per
    row, l = 0 (and m = NEG_INF) where ``live`` [n, S] is false, and an
    accumulator of NaN there, which the merge must never read."""
    m = 4 * torch.randn(n, S, hkv, rows, generator=gen, device="cuda")
    l = 0.5 + torch.rand(n, S, hkv, rows, generator=gen, device="cuda")
    acc = torch.randn(n, S, hkv, rows, d, generator=gen, device="cuda") \
        * l[..., None]
    dead = ~live[:, :, None, None]
    m = torch.where(dead, torch.full_like(m, -1e30), m)
    l = torch.where(dead, torch.zeros_like(l), l)
    acc = torch.where(dead[..., None], torch.full_like(acc, float("nan")),
                      acc)
    return torch.stack([m, l], -1).contiguous(), acc.contiguous()


def combine_check(pa, gen):
    """The merge kernel alone against its plain version: GQA 32:8 with 5
    query rows, D 128, 4 splits, some splits empty, a q_len = 0 slot."""
    live = torch.tensor([[1, 1, 0, 1], [1, 0, 0, 0], [1, 1, 1, 1],
                         [0, 1, 1, 0]], dtype=torch.bool, device="cuda").T
    ml, acc = random_partials(gen, 4, 4, 8, 5 * 4, 128, live)
    q_len = torch.tensor([5, 3, 0, 1], dtype=torch.int32, device="cuda")
    err = 0.0
    for out_dtype in (torch.float32, torch.bfloat16):
        got = pa.ragged_paged_attention_combine(ml, acc, q_len, 32, out_dtype)
        want = pa.ragged_paged_attention_combine_ref(ml, acc, q_len, 32,
                                                     out_dtype)
        # elementwise only: most rows here are zeros (q_len), which the
        # row check's median cannot take
        err = max(err, held(f"combine 4 splits GQA 32:8 [{str(out_dtype)[6:]}]",
                            got, want, TRAIN_TOL[out_dtype][:2] + (None,)))
    return err


def fp8_code_table(pa):
    """Every one of the 256 codes through the quantized kernel: one KV token,
    scale 1, so each output element is exactly the kernel's f32 value of a
    V code — held bit for bit to torch's own conversion (NaN codes
    included)."""
    for kv_dtype, dt in KV_DTYPES.items():
        codes = torch.arange(256, dtype=torch.uint8, device="cuda")
        vq = torch.zeros(2, 1, 16, 128, dtype=torch.uint8, device="cuda")
        vq[:, 0, 0] = codes.reshape(2, 128)
        kq, vq = torch.zeros_like(vq).view(dt), vq.view(dt)
        ones = torch.ones(2, 1, 16, device="cuda")
        one = torch.ones(1, dtype=torch.int32, device="cuda")
        out = pa.ragged_paged_attention(
            torch.randn(1, 1, 2, 128, device="cuda"), kq, vq,
            torch.zeros(1, 1, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"), one, one,
            k_scales=ones, v_scales=ones)
        want = codes.view(dt).float().reshape(1, 1, 2, 128)
        same = (out == want) | (out.isnan() & want.isnan())
        require(bool(same.all()), f"{kv_dtype} code table: "
                f"{int((~same).sum())} of 256 codes convert differently")
        print(f"  {kv_dtype} -> f32 over all 256 codes: equal to torch's "
              f"({int(want.isnan().sum())} NaN codes)")


# -- phase 2b: the train kernels against their plain versions ----------------
# (B, S_q, S_k, Hq, Hkv, D), causal, dtype
TRAIN_ATTN_CASES = [
    ("train shape", (8, 2048, 2048, 16, 16, 64), True, torch.bfloat16),
    ("GQA 16:4 D=128", (2, 512, 512, 16, 4, 128), True, torch.bfloat16),
    ("f32 GQA 4:2", (2, 256, 256, 4, 2, 64), True, torch.float32),
    ("s_q < s_k non-causal", (2, 128, 384, 8, 4, 64), False, torch.float32),
    ("s_q < s_k causal", (1, 128, 384, 4, 4, 128), True, torch.float32),
    # lengths off the 64-row tile: a partial last q tile and k tile
    ("s_k = 200 non-causal", (2, 128, 200, 4, 2, 64), False, torch.float32),
    ("s_k = 200 non-causal", (2, 128, 200, 8, 4, 128), False, torch.bfloat16),
    ("s_q = s_k = 200 causal", (2, 200, 200, 8, 8, 64), True, torch.bfloat16),
    # the bf16 kernels' own tiling: 128-row forward q tiles, 128-key dK/dV
    # blocks and 64-row (32 at D = 128) streamed q tiles
    ("s_q < s_k causal", (2, 128, 384, 8, 4, 64), True, torch.bfloat16),
    ("GQA 16:4 S=320 (partial 128-row tile)", (2, 320, 320, 16, 4, 64), True,
     torch.bfloat16),
    ("S=200 causal D=128", (2, 200, 200, 8, 8, 128), True, torch.bfloat16),
    ("one short q tile", (2, 64, 2048, 16, 16, 64), True, torch.bfloat16),
    # the bf16 dQ kernel's tiling: 64-row q blocks holding Q and dO in
    # registers, 64-key K / V tiles worked 16 keys at a time
    ("dQ D=128 GQA 16:4 S=320", (2, 320, 320, 16, 4, 128), True,
     torch.bfloat16),
    ("dQ q length 136 (inside a q block)", (2, 136, 136, 8, 8, 64), True,
     torch.bfloat16),
    ("dQ s_q < s_k causal GQA 16:4", (2, 136, 520, 16, 4, 64), True,
     torch.bfloat16),
    ("dQ S=200 non-causal GQA 16:4", (2, 200, 200, 16, 4, 64), False,
     torch.bfloat16),
    # the wgmma dK/dV and dQ without segments: GQA 8:2 causal off the tile
    ("GQA 8:2 S=200 causal", (2, 200, 200, 8, 2, 64), True, torch.bfloat16),
    # the forward's persistent grid (288 q tiles over 132 SMs) with GQA 4:1:
    # 128-key tiles at D 64, 64-key tiles at D 96 off the tile
    ("GQA 4:1 persistent 128-key tiles", (2, 256, 256, 72, 18, 64), True,
     torch.bfloat16),
    ("GQA 4:1 persistent D=96 S=200", (2, 200, 200, 72, 18, 96), False,
     torch.bfloat16),
]
# (name, N, H, x dtype, w dtype): the forward's and backward's register
# passes (bf16 rows of up to 1,024), N off the backward's row runs and
# below a block's 8 rows, and the general loops (H not a multiple of 8, H
# above 1,024, f32 x)
TRAIN_RMS_CASES = [
    ("train rows", 16384, 1024, torch.bfloat16, torch.bfloat16),
    ("f32 rows", 4096, 1024, torch.float32, torch.float32),
    ("N off the row runs, f32 w", 16411, 1024, torch.bfloat16,
     torch.float32),
    ("H=768 rows", 1003, 768, torch.bfloat16, torch.bfloat16),
    ("N below 8 rows", 5, 1024, torch.bfloat16, torch.bfloat16),
    ("H=1000 (general loop)", 4096, 1000, torch.bfloat16, torch.bfloat16),
    ("H=4096 (general loop)", 1024, 4096, torch.bfloat16, torch.bfloat16),
    ("f32 x, bf16 w", 4096, 1024, torch.float32, torch.bfloat16),
]
# phase 2c: ERNIE-base's attention (non-causal, S 512, 12 heads of 64), its
# LayerNorm rows (B 64 x S 512 tokens of 768), its attention-probability
# rows for the softmax entry ([8, 12, 512, 512]) and AdamW over its largest
# tensor (the 40,000 x 768 word embedding) and two short ones
ERNIE_ATTN_CASES = [("ERNIE shape", (8, 512, 512, 12, 12, 64), False,
                     torch.bfloat16)]
# phase 2c: the dropout branch of rows 3/5/6 at ERNIE's rate, against the
# plain versions under the same seed: ERNIE's shape, bf16 and f32, D 64
# and 128, causal and not, GQA 8:2, s_k off the 64-row tile, s_q < s_k
# causal (dK/dV's first visible q tile) and S 200 causal (partial q tiles)
DROPOUT_RATE = 0.1                 # ERNIE-3.0-base's published rates
DROPOUT_ATTN_CASES = [
    ("ERNIE shape", (8, 512, 512, 12, 12, 64), False, torch.bfloat16),
    ("causal D=128", (2, 256, 256, 8, 8, 128), True, torch.bfloat16),
    ("GQA 8:2 causal", (2, 256, 256, 8, 2, 64), True, torch.bfloat16),
    ("s_k = 200 non-causal D=128", (2, 128, 200, 8, 4, 128), False,
     torch.bfloat16),
    ("s_q < s_k causal", (2, 128, 384, 8, 4, 64), True, torch.bfloat16),
    ("S=200 causal", (2, 200, 200, 8, 8, 64), True, torch.bfloat16),
    ("f32 GQA 8:2 causal", (2, 128, 128, 8, 2, 64), True, torch.float32),
    ("f32 D=128 s_k = 200", (2, 128, 200, 4, 4, 128), False, torch.float32),
    # the forward's persistent grid with GQA 4:1 (as TRAIN_ATTN_CASES)
    ("GQA 4:1 persistent 128-key tiles", (2, 256, 256, 72, 18, 64), False,
     torch.bfloat16),
    ("GQA 4:1 persistent D=96 S=200 causal", (2, 200, 200, 72, 18, 96), True,
     torch.bfloat16),
]
# (name, (B, S_q, S_k, Hq, Hkv, D), dtype) of the masks read out of every
# dropout kernel (``check_masks``), causal and not: the bf16 tensor-core
# kernels at ERNIE's D 64 with GQA 8:2 and lengths off the 64-row tile, at
# D 128 with s_q < s_k (the wgmma dK/dV's 32-row q tiles), at D 40 (W 48,
# a zero-padded panel), at D 160 (dK/dV on mma.sync, its one width there)
# and at D 192 (the wgmma dK/dV's output panels split over two blocks,
# two panels and one, that each draw the mask); the forward's persistent
# grids with GQA 4:1 over 288 q tiles (more than the card's SMs): 128-key
# tiles at D 64 (two registers of keep bits) and 64-key tiles at D 80 (W
# 96, off the tile); the f32 kernels likewise, and last the f32 kernels
# over B x Hq x 128 x 128 scores (over 10^7) for the keep rate
MASK_READOUTS = [
    ("bf16 D=64 GQA 8:2 S=200", (2, 200, 200, 8, 2, 64), torch.bfloat16),
    ("bf16 D=128 s_q 136 < s_k 200", (2, 136, 200, 4, 4, 128),
     torch.bfloat16),
    ("bf16 D=40 GQA 4:2 S=136", (2, 136, 136, 4, 2, 40), torch.bfloat16),
    ("bf16 D=160 s_q 72 < s_k 200", (1, 72, 200, 4, 4, 160),
     torch.bfloat16),
    ("bf16 D=192 GQA 4:2 S=200", (1, 200, 200, 4, 2, 192), torch.bfloat16),
    ("bf16 D=64 GQA 4:1 persistent", (2, 256, 256, 72, 18, 64),
     torch.bfloat16),
    ("bf16 D=80 GQA 4:1 persistent S=200", (2, 200, 200, 72, 18, 80),
     torch.bfloat16),
    ("f32 D=64 GQA 8:2 s_q 136 < s_k 200", (2, 136, 200, 8, 2, 64),
     torch.float32),
    ("f32 D=128 GQA 16:4 S=128", (40, 128, 128, 16, 4, 128), torch.float32),
]
ERNIE_ATTN_SHAPE = (64, 512, 512, 12, 12, 64)   # phase 3d's B 64 x S 512
ERNIE_LN_ROWS = (32768, 768)
# (name, N, H, x dtype, w dtype) of the LayerNorm kernels: the backward's
# register pass (bf16 rows of up to 1,024) at ERNIE's rows and at H 1,024,
# N off its grid's row runs and below a block's 8 rows, and its general
# loop (H not a multiple of 8, H above 1,024, f32 x); the rows of phase 3h's
# UNet (B 8: 32 x 32 tokens of 640 and 16 x 16 of 1,280).  The cases with
# f32 w hold f32 dw and db summed over 32,768+ rows by both passes
LN_CASES = [
    ("ERNIE rows", *ERNIE_LN_ROWS, torch.bfloat16, torch.bfloat16),
    ("H=1024 rows", 4096, 1024, torch.bfloat16, torch.bfloat16),
    ("N off the row runs, f32 w", 32771, 768, torch.bfloat16, torch.float32),
    ("N below 8 rows", 5, 768, torch.bfloat16, torch.bfloat16),
    ("H=1000 (general loop)", 4096, 1000, torch.bfloat16, torch.bfloat16),
    ("H=4096 (general loop)", 2048, 4096, torch.bfloat16, torch.bfloat16),
    ("f32 rows (general loop)", *ERNIE_LN_ROWS, torch.float32, torch.float32),
    ("bf16 x, f32 w", 4096, 1024, torch.bfloat16, torch.float32),
    ("UNet level 1 rows", 8192, 640, torch.bfloat16, torch.bfloat16),
    ("UNet level 2 rows", 2048, 1280, torch.bfloat16, torch.bfloat16),
]
SOFTMAX_SHAPE = (8, 12, 512, 512)
# the softmax forward's register pass at its longest row (2,048), and its
# looped kernel past that and at a row that is not a whole 16-byte vector
SOFTMAX_BRANCH_ROWS = ((4096, 2048), (2048, 4096), (4096, 1002))
ADAMW_LENGTHS = (40000 * 768, 768, 40000)
# (atol, rtol, row_rtol) of the train kernels against their plain versions.
# f32 kernels and f32 plain versions differ only in summation order.  In
# bf16 both sides round their outputs to bf16 (one ulp is at most 2**-7
# relative); the forward kernel also rounds p to bf16 before P V, as the
# TPU kernel does (2**-8 relative per term), where the plain version keeps
# f32, and the backward kernels carry p and ds to 2**-16.  So bf16 is held
# elementwise to two ulps of |plain| plus 2e-3 (plus, for the forward's o,
# 2**-8 sum_j p_j |v_j| / l: the p rounding's own bound), and every row
# (the last axis: one head's D values, one RMSNorm row) to 1.6e-2 of its
# plain norm, which a mis-weighted key tile in a long row would break.
# Rows whose plain norm is under 1% of the median row's are what is left
# of a cancellation (dQ of a query that sees one key is 0 up to rounding)
# and are held by the elementwise bound alone.
TRAIN_TOL = {torch.float32: (1e-5, 1e-5, None),
             torch.bfloat16: (2e-3, 1.6e-2, 1.6e-2)}
# the dropout branch of rows 3, 5 and 6: its own entries of the kernels line
DROP_KEYS = ("fa_fwd_drop", "fa_dkv_drop", "fa_dq_drop")
DROP_ROWS = [
    dict(key="fa_fwd_drop", name="flash_attention_fwd (dropout)",
         route="cuda", source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:115"),
    dict(key="fa_dkv_drop", name="flash_attention_bwd_dkv (dropout)",
         route="cuda", source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:317"),
    dict(key="fa_dq_drop", name="flash_attention_bwd_dq (dropout)",
         route="cuda", source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:391"),
]
# the segment branch of rows 3, 5 and 6 (the varlen mask, and the padding of
# an untileable sequence): its own entries of the kernels line
SEG_KEYS = ("fa_fwd_seg", "fa_dkv_seg", "fa_dq_seg")
SEG_ROWS = [
    dict(key="fa_fwd_seg", name="flash_attention_fwd (segments)",
         route="cuda", source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:102"),
    dict(key="fa_dkv_seg", name="flash_attention_bwd_dkv (segments)",
         route="cuda", source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:310"),
    dict(key="fa_dq_seg", name="flash_attention_bwd_dq (segments)",
         route="cuda", source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:384"),
]
TRAIN_ROWS = [
    dict(key="fa_fwd", name="flash_attention_fwd", route="cuda",
         source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:64"),
    dict(key="pack_lse", name="pack_lse", route="cuda",
         source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:134"),
    dict(key="fa_dkv", name="flash_attention_bwd_dkv", route="cuda",
         source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:268"),
    dict(key="fa_dq", name="flash_attention_bwd_dq", route="cuda",
         source=CSRC + "flash_attention.cu",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:347"),
    dict(key="rms_fwd", name="rms_norm_fwd", route="cuda",
         source=CSRC + "rms_norm.cu",
         replaces="paddle_tpu/ops/pallas/fused.py:58"),
    dict(key="rms_bwd", name="rms_norm_bwd", route="cuda",
         source=CSRC + "rms_norm.cu",
         replaces="paddle_tpu/ops/pallas/fused.py:66"),
]
FUSED_ROWS = [
    dict(key="adamw", name="adamw_update", route="cuda",
         source=CSRC + "adamw.cu",
         replaces="paddle_tpu/ops/pallas/fused.py:165"),
    dict(key="softmax_fwd", name="softmax_fwd", route="cuda",
         source=CSRC + "softmax.cu",
         replaces="paddle_tpu/ops/pallas/fused.py:246"),
    dict(key="softmax_bwd", name="softmax_bwd", route="cuda",
         source=CSRC + "softmax.cu",
         replaces="paddle_tpu/ops/pallas/fused.py:253"),
    dict(key="ln_fwd", name="layer_norm_fwd", route="cuda",
         source=CSRC + "layer_norm.cu",
         replaces="paddle_tpu/ops/pallas/fused.py:312"),
    dict(key="ln_bwd", name="layer_norm_bwd", route="cuda",
         source=CSRC + "layer_norm.cu",
         replaces="paddle_tpu/ops/pallas/fused.py:324"),
]
# AdamW: every operation of the kernel rounds on its own in the plain
# version's order, so the two agree bit for bit; held to one ulp of |plain|
ADAMW_TOL = {torch.float32: (0.0, 2.0 ** -23, None),
             torch.bfloat16: (0.0, 2.0 ** -8, None)}


def held(name, got, want, tol, extra=None):
    """Kernel output against the plain version's: elementwise within
    atol + rtol * |plain| (+ ``extra``, an elementwise allowance), and,
    where row_rtol is set, every row (the last axis) whose plain norm is at
    least 1% of the median row's within row_rtol of that norm.  Prints the
    max abs error, the max over the elements whose |plain| is at most the
    median, and the worst row's relative error; returns the max abs
    error."""
    torch.cuda.synchronize()
    atol, rtol, row_rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_err = err.max().item()
    mag = want.abs()
    small_err = err[mag <= mag.flatten().median()].max().item()
    bound = atol + rtol * mag if extra is None else atol + rtol * mag + extra
    rows = (got - want).reshape(-1, want.shape[-1])
    ref_norm = want.reshape(rows.shape).norm(dim=-1)
    big = ref_norm >= 0.01 * ref_norm.median()
    worst_row = (rows[big].norm(dim=-1) / ref_norm[big]).max().item() \
        if bool(big.any()) else 0.0
    require(bool(torch.isfinite(got).all())
            and bool((err <= bound).all())
            and (row_rtol is None or worst_row <= row_rtol),
            f"{name}: kernel vs plain max abs err {max_err:.3e}, worst row "
            f"{worst_row:.3e} (atol {atol}, rtol {rtol}, row {row_rtol})")
    row_tol = "" if row_rtol is None else f", row {row_rtol:g}"
    row_tol = row_tol if extra is None else " + p rounding" + row_tol
    print(f"  {name:<50} max_abs_err={max_err:.3e} at small |ref| "
          f"{small_err:.3e}, worst row {worst_row:.2e} (tol {atol:g} + "
          f"{rtol:g}*|ref|{row_tol})")
    return max_err


def attn_inputs(gen, shape, dtype):
    b, s_q, s_k, hq, hkv, d = shape
    mk = lambda s, h: torch.randn(b, s, h, d, generator=gen,
                                  device="cuda").to(dtype)
    return mk(s_q, hq), mk(s_k, hkv), mk(s_k, hkv), mk(s_q, hq)


def delta_of(do, o):
    b, s_q, hq, _ = o.shape
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
        .reshape(b * hq, s_q).contiguous()


def segment_ids(lens, b, device="cuda"):
    """[B, S] segment ids of the lengths ``lens`` (summing to S), rotated
    by one segment per batch row so that the rows' boundaries differ; or,
    for ``lens`` a numpy array, those ids themselves (one per token, in any
    order, an id free to recur), rolled by 17 tokens per batch row."""
    if isinstance(lens, np.ndarray):
        return torch.stack([torch.from_numpy(np.roll(lens, 17 * r))
                            for r in range(b)]).to(device)
    rows = [torch.repeat_interleave(torch.arange(len(lens)), torch.tensor(
        lens[r % len(lens):] + lens[:r % len(lens)])) for r in range(b)]
    return torch.stack(rows).to(device)


def spans(*pairs):
    """Per-token ids of (id, length) spans in order: ids out of order and
    ids that recur in two spans, as packed inputs may have them."""
    return np.concatenate([np.full(n, i) for i, n in pairs]).astype(np.int32)


def packed_lengths(total, lo=5, hi=300, seed=3):
    """Lengths drawn uniformly from [lo, hi] until they fill ``total``
    tokens (the last one cut to fit): a packed varlen batch row."""
    rng = np.random.default_rng(seed)
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.integers(lo, hi + 1)))
    lens[-1] -= sum(lens) - total
    return lens


def fwd_tiles(fa, shape, causal, segments):
    """(q rows, keys, ", persistent" or "") of the design that the bf16
    forward's dispatch gives a launch at ``shape`` (B, S_q, S_k, Hq, Hkv,
    D)."""
    b, s_q, s_k, hq, _, d = shape
    bq, bk, persistent = fa.FWD_DESIGNS[fa.kernel_fwd_design(
        b, hq, s_q, s_k, d, causal, segments)]
    return bq, bk, ", persistent" * persistent


def attention_checks(fa, gen, cases, worst, rate=0.0, keys=None):
    """Rows 3, 5 and 6 against their plain versions over ``cases``, with
    ``rate`` > 0 the dropout branch under one seed per case (the plain
    versions rebuild the mask from it); a case's optional fifth entry
    takes the segment branch: segment lengths (``segment_ids``), or "pad"
    for inputs of S rows padded to the tile by the op's ``_pad_to_tile``
    (dO's padding rows zero, as the op's backward gets them).  The worst
    absolute error of each goes into ``worst`` under ``keys`` (default:
    fa_fwd, fa_dkv, fa_dq)."""
    k_fwd, k_dkv, k_dq = keys or ("fa_fwd", "fa_dkv", "fa_dq")
    for key in (k_fwd, k_dkv, k_dq):
        worst.setdefault(key, 0.0)
    for i, (name, shape, causal, dt, *lens) in enumerate(cases):
        q, k, v, do = attn_inputs(gen, shape, dt)
        seg = None
        if len(lens) == 1 and isinstance(lens[0], str):
            q, k, v, seg, s = fa._pad_to_tile(q, k, v, None)
            do = torch.nn.functional.pad(do, (0, 0, 0, 0, 0,
                                              q.shape[1] - s))
        elif lens:
            seg = segment_ids(lens[0], shape[0])
        sc = 1.0 / np.sqrt(shape[-1])
        seed = (i + 1) << 33 | 12345 if rate > 0 else 0
        tag = f"{name} {shape} causal={causal} [{str(dt)[6:]}]"
        tag += f" rate {rate}" if rate > 0 else ""
        if dt == torch.bfloat16:
            tag += " (forward %d x %d%s)" % fwd_tiles(fa, shape, causal,
                                                      seg is not None)
        tol = TRAIN_TOL[dt]
        args = (causal, sc, rate, seed, seg)
        o, lse = fa.flash_attention_fwd(q, k, v, *args)
        ro, rlse = fa.flash_attention_fwd_ref(q, k, v, *args)
        # the bf16 kernel rounds p (dropped, under dropout) to bf16 before
        # P V, as the TPU kernel does: term j may move by 2**-8 p_j |v_j|,
        # so o by 2**-8 times the plain forward of |v|
        p_round = None if dt == torch.float32 else 2.0 ** -8 * \
            fa.flash_attention_fwd_ref(q, k, v.abs(), *args)[0].float()
        worst[k_fwd] = max(worst[k_fwd],
                           held(f"fwd o   {tag}", o, ro, tol, p_round),
                           held(f"fwd lse {tag}", lse, rlse,
                                TRAIN_TOL[torch.float32]))
        del ro, rlse, p_round
        delta = delta_of(do, o)
        got = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args)
        want = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, *args)
        worst[k_dkv] = max(worst[k_dkv],
                           held(f"dk {tag}", got[0], want[0], tol),
                           held(f"dv {tag}", got[1], want[1], tol))
        del got, want
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, *args)
        rdq = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, *args)
        worst[k_dq] = max(worst[k_dq], held(f"dq {tag}", dq, rdq, tol))
        del q, k, v, do, o, lse, delta, dq, rdq
        torch.cuda.empty_cache()


# head widths whose bf16 dK/dV without segments keeps mma.sync, with or
# without dropout, as flash_attention.cuh kMmaSyncDkvWidth names them
# (phase 5e's ``WIDE_VARIANTS`` time the two bodies above two 64-column
# panels)
MMA_SYNC_DKV_WIDTHS = (160,)


def want_bodies(fa, d, segments, dropout):
    """The body each bf16 launch of rows 3, 5 and 6 must take at head dim
    ``d``: the forward and dQ wgmma; dK/dV wgmma but without segments at
    ``MMA_SYNC_DKV_WIDTHS``, with or without dropout."""
    dkv = segments or fa.head_width(d) not in MMA_SYNC_DKV_WIDTHS
    return {"fwd": "wgmma",
            "bwd_dkv": "wgmma" if dkv else "mma.sync",
            "bwd_dq": "wgmma"}


def launch_bodies(fa, d, segments, dropout, dtype=torch.bfloat16):
    """{launch: the body the library's dispatch gives it} (``kernel_body``)
    for rows 3, 5 and 6 at head dim ``d``."""
    return {w: fa.kernel_body(w, dtype, d, segments, dropout)
            for w in ("fwd", "bwd_dkv", "bwd_dq")}


def require_bodies(fa, what, d, segments, dropout):
    """Prints the bodies that ``what``'s launches of rows 3, 5 and 6 ran
    (bf16, head dim ``d``) and requires ``want_bodies``'."""
    body = launch_bodies(fa, d, segments, dropout)
    print(f"  {what} ran the bodies: forward {body['fwd']}, dK/dV "
          f"{body['bwd_dkv']}, dQ {body['bwd_dq']} (the library's dispatch, "
          f"bf16, D {d}, segments {segments}, dropout {dropout})")
    want = want_bodies(fa, d, segments, dropout)
    require(body == want, f"{what}: bodies {body} != {want}")


# (B, S_q, S_k, Hq, D, causal) of the forward launches whose design the
# dispatch reports: 3c's, 3d's, 3h's, ViT's segment launch (577 rows padded
# to 640), 512 q tiles at the widths no model takes and S 200 at every width
FWD_DESIGN_LAUNCHES = (
    (8, 2048, 2048, 16, 64, True), (64, 512, 512, 12, 64, False),
    (8, 4096, 4096, 8, 40, False), (8, 1024, 1024, 8, 80, False),
    (8, 256, 256, 8, 160, False), (32, 640, 640, 16, 64, False),
    *((8, 1024, 1024, 8, d, False) for d in (32, 96, 128, 192, 256)),
    *((2, 200, 200, 4, d, c) for d in (24, 40, 56, 72, 96, 112, 176, 200,
                                       256) for c in (False, True)))


def fwd_designs(fa):
    """The design of each bf16 forward launch of ``FWD_DESIGN_LAUNCHES``,
    without segments and (ViT's shape) with, read from the library's
    dispatch (``kernel_fwd_design``): the segment branch takes a block per
    q tile of 64-key tiles, and a launch takes a persistent grid only where
    its q tiles outnumber the card's SMs."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lines = []
    for b, s_q, s_k, hq, d, causal in FWD_DESIGN_LAUNCHES:
        for seg in (False, True) if s_q == 640 else (False,):
            got = fa.kernel_fwd_design(b, hq, s_q, s_k, d, causal, seg)
            require(got in range(len(fa.FWD_DESIGNS)),
                    f"forward design {got} at {(b, s_q, s_k, hq, d)}")
            bq, bk, persistent = fa.FWD_DESIGNS[got]
            tiles = b * hq * -(-s_q // bq)
            require(not (seg and got != 0) and (tiles > sms or not persistent),
                    f"forward design at {(b, s_q, s_k, hq, d)} causal="
                    f"{causal} segments={seg}: {bq} x {bk}, persistent "
                    f"{persistent}, over {tiles} q tiles on {sms} SMs")
            lines.append(f"[{b}, {s_q}, {hq}, {d}]{' causal' * causal}"
                         f"{' segments' * seg}: {bq} x {bk}"
                         f"{' persistent' * persistent}")
    print("  forward designs (q rows x keys a tile) from the dispatch: "
          + "; ".join(lines))


def phase_train_kernels(fa, fu):
    """Every launch of rows 3/5/6 takes its body (``want_bodies``, at every
    head width of phase 2e and D 64 / 128, bf16 with and without segments
    and dropout; f32 the CUDA cores); rows 3-8 against their plain
    versions.  Returns the worst absolute error of each."""
    dims = sorted({64, 128, *HEAD_DIMS_2E})
    for d in dims:
        for segments in (False, True):
            for dropout in (False, True):
                body = launch_bodies(fa, d, segments, dropout)
                want = want_bodies(fa, d, segments, dropout)
                require(body == want, f"bf16 D {d} segments {segments} "
                        f"dropout {dropout}: bodies {body} != {want}")
                body = launch_bodies(fa, d, segments, dropout, torch.float32)
                require(set(body.values()) == {"cuda cores"},
                        f"f32 D {d}: bodies {body}")
    print(f"  at head dims {dims}: bf16 forward and dQ take wgmma, and "
          f"dK/dV too but without segments at widths {MMA_SYNC_DKV_WIDTHS} "
          f"(mma.sync); f32 the CUDA cores")
    fwd_designs(fa)
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {r["key"]: 0.0 for r in TRAIN_ROWS}
    attention_checks(fa, gen, TRAIN_ATTN_CASES, worst)
    # the standalone repack on strided [BH, S, 1] stats
    lse3 = torch.randn(128, 2048, 2, generator=gen, device="cuda")[..., 1:]
    worst["pack_lse"] = held("pack_lse [128, 2048, 1] strided",
                             fa.pack_lse(lse3), fa.pack_lse_ref(lse3),
                             (0.0, 0.0, None))
    for name, n, h, dt, wdt in TRAIN_RMS_CASES:
        x = torch.randn(n, h, generator=gen, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(wdt)
        g = torch.randn(n, h, generator=gen, device="cuda").to(dt)
        tol = TRAIN_TOL[dt]
        tag = f"{name} [{n}, {h}] [{str(dt)[6:]}, w {str(wdt)[6:]}]"
        out, inv = fu.rms_norm_fwd(x, w, 1e-5)
        rout, rinv = fu.rms_norm_fwd_ref(x, w, 1e-5)
        worst["rms_fwd"] = max(worst["rms_fwd"],
                               held(f"rms out {tag}", out, rout, tol),
                               held(f"rms inv {tag}", inv, rinv,
                                    TRAIN_TOL[torch.float32]))
        dx, dw = fu.rms_norm_bwd(x, w, inv, g)
        rdx, rdw = fu.rms_norm_bwd_ref(x, w, inv, g)
        # dw is rounded to w's dtype; f32 dw sums n rows in another order
        # than torch.sum does
        dw_tol = TRAIN_TOL[wdt] if wdt == torch.bfloat16 \
            else (1e-4, 1e-5, None)
        worst["rms_bwd"] = max(worst["rms_bwd"],
                               held(f"rms dx {tag}", dx, rdx, tol),
                               held(f"rms dw {tag}", dw, rdw, dw_tol))
    return worst


def layer_norm_checks(fu, gen, worst):
    """Rows 12-13 against their plain versions over ``LN_CASES``; for
    f32 dw and db, also the kernel's and torch.sum's distance from a
    float64 sum of the same f32 products (the gate holds the two f32 sums
    against each other); the worst absolute error of each row goes into
    ``worst``."""
    worst["ln_fwd"] = worst["ln_bwd"] = 0.0
    f32 = TRAIN_TOL[torch.float32]
    for name, n, h, dt, wdt in LN_CASES:
        tol = TRAIN_TOL[dt]
        tag = f"{name} [{n}, {h}] [{str(dt)[6:]}, w {str(wdt)[6:]}]"
        x = torch.randn(n, h, generator=gen, device="cuda").to(dt)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(wdt)
        b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(wdt)
        g = torch.randn(n, h, generator=gen, device="cuda").to(dt)
        out, mu, inv = fu.layer_norm_fwd(x, w, b, 1e-12)
        rout, rmu, rinv = fu.layer_norm_fwd_ref(x, w, b, 1e-12)
        worst["ln_fwd"] = max(worst["ln_fwd"],
                              held(f"ln out {tag}", out, rout, tol),
                              held(f"ln mu {tag}", mu, rmu, f32),
                              held(f"ln inv {tag}", inv, rinv, f32))
        dx, dw, db = fu.layer_norm_bwd(x, w, mu, inv, g)
        rdx, rdw, rdb = fu.layer_norm_bwd_ref(x, w, mu, inv, g)
        # dw and db are rounded to w's dtype; f32 dw and db sum n rows in
        # another order than torch.sum does
        dwb_tol = TRAIN_TOL[wdt] if wdt == torch.bfloat16 \
            else (1e-4, 1e-5, None)
        worst["ln_bwd"] = max(worst["ln_bwd"],
                              held(f"ln dx {tag}", dx, rdx, tol),
                              held(f"ln dw {tag}", dw, rdw, dwb_tol),
                              held(f"ln db {tag}", db, rdb, dwb_tol))
        if wdt == torch.float32:
            xhat = (x.float() - mu[:, None]) * inv[:, None]
            gf = g.float()
            exact = [(gf * xhat).double().sum(0), gf.double().sum(0)]
            dist = [(t.double() - e).abs().max().item()
                    for t, e in zip((dw, db, rdw, rdb), exact * 2)]
            print(f"  ln dw, db {tag} from a float64 sum of the same f32 "
                  f"terms: kernel {dist[0]:.3e}, {dist[1]:.3e}; torch.sum "
                  f"{dist[2]:.3e}, {dist[3]:.3e}")
        del x, g, out, rout, dx, rdx
    torch.cuda.empty_cache()


def phase_fused_kernels(fa, fu, worst):
    """Phase 2c: rows 12-13 against their plain versions over
    ``LN_CASES``, rows 9-11 at the ERNIE shapes, bf16 and f32, and
    rows 3/5/6 non-causal at ERNIE's attention shape; the worst absolute
    error of each row goes into ``worst``."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    attention_checks(fa, gen, ERNIE_ATTN_CASES, worst)
    attention_checks(fa, gen, DROPOUT_ATTN_CASES, worst, DROPOUT_RATE,
                     DROP_KEYS)
    mask_readout(fa)
    for key in ("adamw", "softmax_fwd", "softmax_bwd"):
        worst[key] = 0.0
    layer_norm_checks(fu, gen, worst)
    rows = int(np.prod(SOFTMAX_SHAPE[:-1]))
    for dt in (torch.bfloat16, torch.float32):
        tol, tag = TRAIN_TOL[dt], f"[{str(dt)[6:]}]"
        s_in = (2 * torch.randn(rows, SOFTMAX_SHAPE[-1], generator=gen,
                                device="cuda")).to(dt)
        gs = torch.randn(rows, SOFTMAX_SHAPE[-1], generator=gen,
                         device="cuda").to(dt)
        o = fu.softmax_fwd(s_in)
        worst["softmax_fwd"] = max(worst["softmax_fwd"], held(
            f"softmax o {list(SOFTMAX_SHAPE)} {tag}", o, fu.softmax_fwd_ref(
                s_in), tol))
        worst["softmax_bwd"] = max(worst["softmax_bwd"], held(
            f"softmax dx {list(SOFTMAX_SHAPE)} {tag}", fu.softmax_bwd(o, gs),
            fu.softmax_bwd_ref(o, gs), tol))
        # the same rows under a causal -inf mask (query i sees keys <= i),
        # as masked attention scores reach the softmax entry
        s = SOFTMAX_SHAPE[-1]
        q_pos = torch.arange(rows, device="cuda")[:, None] % s
        s_in.masked_fill_(torch.arange(s, device="cuda") > q_pos,
                          float("-inf"))
        o = fu.softmax_fwd(s_in)
        worst["softmax_fwd"] = max(worst["softmax_fwd"], held(
            f"softmax o causal -inf mask {tag}", o, fu.softmax_fwd_ref(s_in),
            tol))
        worst["softmax_bwd"] = max(worst["softmax_bwd"], held(
            f"softmax dx causal -inf mask {tag}", fu.softmax_bwd(o, gs),
            fu.softmax_bwd_ref(o, gs), tol))
        del s_in, gs, o, q_pos
        # the forward's other branches: the register pass at its longest
        # row, and the looped kernel past it and off the 16-byte vector;
        # then a row that is -inf throughout (NaN, as in the plain version)
        for n_rows, h_len in SOFTMAX_BRANCH_ROWS:
            s_in = (2 * torch.randn(n_rows, h_len, generator=gen,
                                    device="cuda")).to(dt)
            s_in[1, : h_len // 2] = float("-inf")
            worst["softmax_fwd"] = max(worst["softmax_fwd"], held(
                f"softmax o [{n_rows}, {h_len}] {tag}", fu.softmax_fwd(s_in),
                fu.softmax_fwd_ref(s_in), tol))
            s_in[2] = float("-inf")
            got, want = fu.softmax_fwd(s_in)[2], fu.softmax_fwd_ref(s_in)[2]
            require(torch.equal(got.isnan(), want.isnan())
                    and bool(torch.isnan(got).all()),
                    f"softmax [{n_rows}, {h_len}] {tag}: an all -inf row "
                    f"differs from the plain version")
        print(f"  softmax rows of -inf throughout {tag}: NaN, as the plain "
              f"version, in every branch")
        del s_in
        for length in ADAMW_LENGTHS:
            p = torch.randn(length, generator=gen, device="cuda").to(dt)
            gp = torch.randn(length, generator=gen, device="cuda").to(dt)
            m = 0.1 * torch.randn(length, generator=gen, device="cuda")
            v = 0.01 * torch.rand(length, generator=gen, device="cuda")
            pows = dict(beta1_pow=torch.tensor(0.9 ** 3, device="cuda"),
                        beta2_pow=torch.tensor(0.999 ** 3, device="cuda"))
            want = fu.adamw_update_ref(p, gp, m, v, lr=1e-4,
                                       weight_decay=0.01, **pows)
            fu.adamw_update(p, gp, m, v, lr=1e-4, weight_decay=0.01, **pows)
            for what, got, ref in zip("pmv", (p, m, v), want):
                worst["adamw"] = max(worst["adamw"], held(
                    f"adamw {what} [{length}] {tag}", got, ref,
                    ADAMW_TOL[dt if what == "p" else torch.float32]))
            del p, gp, m, v, want
        torch.cuda.empty_cache()


def read_masks(fa, shape, dtype, causal, seed, rate=DROPOUT_RATE,
               device="cuda", seg=None):
    """The keep bits of each dropout kernel, read out through one-hot inputs
    beside the same kernel at rate 0.  By key chunks of D (k = v = one-hot
    on the chunk, 0 elsewhere; dO = 1, so dP = 1 on the chunk; delta = 0),
    o / o0 and dq / dq0 are keep / (1 - rate) of (q row, key); by q chunks
    of D, one q head of each GQA group at a time (q = dO = one-hot on the
    chunk in those heads, 0 elsewhere; v = 1; delta = 0), dv / dv0 and
    dk / dk0 are that of (key, q row).  Returns {output: (bits, seen)},
    both bool [B, Hq, S_q, S_k]; ``seen`` marks the scores whose rate-0
    output is non-zero.  ``seg`` [B, S] runs every kernel with segment
    ids."""
    b, s_q, s_k, hq, hkv, d = shape
    g = hq // hkv
    gen = torch.Generator(device=device).manual_seed(5)
    sc = 1.0 / np.sqrt(d)
    out = {n: [torch.zeros(b, hq, s_q, s_k, dtype=torch.bool, device=device)
               for _ in range(2)] for n in ("o", "dq", "dk", "dv")}
    delta = torch.zeros(b * hq, s_q, device=device)

    def one_hot(s, h, off, heads):
        t = torch.zeros(b, s, h, d, device=device)
        j = torch.arange(min(d, s - off), device=device)[:, None]
        t[:, off + j, heads[None, :], j] = 1.0
        return t.to(dtype)

    def record(name, x, x0, where):
        seen = x0 != 0
        out[name][0][where] = x.float() / torch.where(seen, x0.float(),
                                                      1.0) > 0.5
        out[name][1][where] = seen

    q = (0.5 * torch.randn(b, s_q, hq, d, generator=gen,
                           device=device)).to(dtype)
    ones_q = torch.ones(b, s_q, hq, d, device=device).to(dtype)
    for off in range(0, s_k, d):
        w = min(d, s_k - off)
        kv = one_hot(s_k, hkv, off, torch.arange(hkv, device=device))
        o, _ = fa.flash_attention_fwd(q, kv, kv, causal, sc, rate, seed, seg)
        o0, lse = fa.flash_attention_fwd(q, kv, kv, causal, sc, 0.0, 0, seg)
        dq, dq0 = (fa.flash_attention_bwd_dq(q, kv, kv, ones_q, lse, delta,
                                             causal, sc, r, seed, seg)
                   for r in (rate, 0.0))
        for name, x, x0 in (("o", o, o0), ("dq", dq, dq0)):
            record(name, *(t[..., :w].permute(0, 2, 1, 3) for t in (x, x0)),
                   (Ellipsis, slice(off, off + w)))
    k = (0.5 * torch.randn(b, s_k, hkv, d, generator=gen,
                           device=device)).to(dtype)
    v = torch.ones(b, s_k, hkv, d, device=device).to(dtype)
    for off in range(0, s_q, d):
        w = min(d, s_q - off)
        for j in range(g):
            heads = torch.arange(hkv, device=device) * g + j
            qd = one_hot(s_q, hq, off, heads)
            _, lse = fa.flash_attention_fwd(qd, k, v, causal, sc, 0.0, 0, seg)
            (dk, dv), (dk0, dv0) = (
                fa.flash_attention_bwd_dkv(qd, k, v, qd, lse, delta, causal,
                                           sc, r, seed, seg)
                for r in (rate, 0.0))
            for name, x, x0 in (("dk", dk, dk0), ("dv", dv, dv0)):
                record(name, *(t[..., :w].permute(0, 2, 3, 1)
                               for t in (x, x0)),
                       (slice(None), heads, slice(off, off + w)))
    return {n: tuple(x) for n, x in out.items()}


def check_masks(fa, shape, dtype, causal, seed, rate=DROPOUT_RATE,
                device="cuda", seg=None):
    """Every kernel's keep bits (``read_masks``) equal ``dropout_keep``'s,
    and each kernel saw exactly the visible scores (with ``seg``, only
    those whose q row and key share a segment); returns the number of
    visible scores and the share of them kept."""
    b, s_q, s_k, hq, hkv, d = shape
    want = fa.dropout_keep(seed, torch.arange(b * hq, device=device),
                           torch.arange(s_q, device=device),
                           torch.arange(s_k, device=device), rate) \
        .reshape(b, hq, s_q, s_k)
    rows = torch.arange(s_q, device=device)[:, None]
    visible = (rows + (s_k - s_q if causal else s_k)
               >= torch.arange(s_k, device=device)).expand(b, hq, s_q, s_k)
    if seg is not None:
        visible = visible & (seg[:, None, :, None] == seg[:, None, None, :])
    tag = f"{list(shape)} {str(dtype)[6:]} causal={causal}"
    tag += "" if seg is None else " segments"
    for name, (bits, seen) in read_masks(fa, shape, dtype, causal, seed,
                                         rate, device, seg).items():
        require(torch.equal(seen, visible), f"mask read-out {name} {tag}: "
                f"{int((seen != visible).sum())} scores seen where not "
                f"visible or not seen where visible")
        wrong = int((bits[seen] != want[seen]).sum())
        require(wrong == 0, f"mask read-out {name} {tag}: {wrong} of "
                f"{int(seen.sum())} keep bits differ from dropout_keep")
    n = int(visible.sum())
    return n, float(want[visible].float().mean())


def mask_readout(fa):
    """The dropout masks of the forward, dK/dV and dQ kernels read out
    (``check_masks``) over ``MASK_READOUTS``, causal and not: every bit
    must equal ``dropout_keep``, and over the last non-causal case's
    scores (over 10^7) the keep rate must lie within 5 sigma of 1 -
    rate."""
    seed = (7 << 32) | 2024
    for name, shape, dt in MASK_READOUTS:
        for causal in (False, True):
            n, kept = check_masks(fa, shape, dt, causal, seed)
            sigma = (DROPOUT_RATE * (1 - DROPOUT_RATE) / n) ** 0.5
            tiles = ""
            if dt == torch.bfloat16:
                design = fwd_tiles(fa, shape, causal, False)
                require(("persistent" in name) == bool(design[2]),
                        f"mask read-out {name}: forward {design}")
                tiles = ", forward %d x %d%s" % design
            print(f"  dropout masks read out of o, dq, dk and dv ({name}, "
                  f"causal={causal}{tiles}): {n:,} scores each, every bit "
                  f"equal to dropout_keep; kept {kept:.6f} (1 - rate = "
                  f"{1 - DROPOUT_RATE:g}, sigma {sigma:.2e})")
            if name == MASK_READOUTS[-1][0] and not causal:
                require(n >= 10 ** 7 and abs(kept - (1 - DROPOUT_RATE))
                        <= 5 * sigma, f"keep rate {kept} over {n} scores")


# -- phase 2d: the segment branch of rows 3/5/6 -------------------------------
# ids out of order, with id 3 at rows 0-99 and 160-199 and id 1 at 100-159
# and 320-383: boundaries inside tiles, and tiles between the two spans of
# an id that share no id with them; then ids 3 and 1 recurring on the
# 64-row tiles, where whole tiles are skipped or full
SPANS_RECUR = spans((3, 100), (1, 60), (3, 40), (0, 56), (2, 64), (1, 64))
SPANS_ALIGNED = spans((3, 64), (1, 64), (2, 128), (3, 64), (1, 64))
SPANS_READOUT = spans((3, 64), (1, 64), (3, 64), (0, 64))
# (name, (B, S, S, Hq, Hkv, D), causal, dtype, segment lengths, per-token
# ids (``spans``) or "pad"): the JAX suite's [0]*100 + [1]*156 (a boundary
# inside a 64-row tile), boundaries on and off the 64 and 128 tiles with a
# segment wholly inside one tile, packed varlen rows of lengths 5..300, GQA
# 8:2, D 64 and 128, causal and not, bf16 and f32; and the op's pad-to-tile
# inputs at S 390, 453 and ViT-L/16's 577 (16 heads of 64).  The bf16 cases
# run the wgmma bodies of the forward and dK / dV, whose tile classes
# (``segment_tile_plan``) the cases at the end aim at: segments on the
# 64-row tiles, so that whole tiles are skipped; a segment inside one tile;
# ids out of order, and an id that recurs in two spans (the [min, max]
# rule must not skip a tile that shares an id); GQA 8:2 causal over them
SEG_ATTN_CASES = [
    ("[0]*100 + [1]*156", (4, 256, 256, 8, 8, 64), False, torch.bfloat16,
     [100, 156]),
    ("[0]*100 + [1]*156", (4, 256, 256, 8, 8, 64), True, torch.bfloat16,
     [100, 156]),
    ("[0]*100 + [1]*156 GQA 8:2", (2, 256, 256, 8, 2, 64), True,
     torch.bfloat16, [100, 156]),
    ("64/10/118/128 D=128", (2, 320, 320, 8, 8, 128), True, torch.bfloat16,
     [64, 10, 118, 128]),
    ("packed varlen 5..300", (2, 2048, 2048, 8, 8, 64), False,
     torch.bfloat16, packed_lengths(2048)),
    ("packed varlen 5..300 D=128 GQA 8:4", (2, 1024, 1024, 8, 4, 128), True,
     torch.bfloat16, packed_lengths(1024, seed=4)),
    ("f32 [0]*100 + [1]*156 GQA 4:2", (2, 256, 256, 4, 2, 64), True,
     torch.float32, [100, 156]),
    ("f32 packed varlen D=128", (1, 512, 512, 4, 4, 128), False,
     torch.float32, packed_lengths(512, seed=5)),
    ("pad to tile S=390", (2, 390, 390, 16, 16, 64), False, torch.bfloat16,
     "pad"),
    ("pad to tile S=453", (2, 453, 453, 16, 16, 64), True, torch.bfloat16,
     "pad"),
    ("pad to tile S=577 (ViT-L/16, 384 px)", (8, 577, 577, 16, 16, 64),
     False, torch.bfloat16, "pad"),
    ("f32 pad to tile S=453 D=128", (1, 453, 453, 4, 4, 128), True,
     torch.float32, "pad"),
    ("tile-aligned 128/128/64/192 (skipped tiles)", (2, 512, 512, 8, 8, 64),
     False, torch.bfloat16, [128, 128, 64, 192]),
    ("tile-aligned 128/128/64/192 GQA 8:2", (2, 512, 512, 8, 2, 64), True,
     torch.bfloat16, [128, 128, 64, 192]),
    ("70/20/38/128 (a segment inside one tile)", (2, 256, 256, 8, 8, 64),
     False, torch.bfloat16, [70, 20, 38, 128]),
    ("unsorted ids, ids 3 and 1 recur", (2, 384, 384, 8, 8, 64), False,
     torch.bfloat16, SPANS_RECUR),
    ("unsorted ids, ids 3 and 1 recur, GQA 8:2", (2, 384, 384, 8, 2, 64),
     True, torch.bfloat16, SPANS_RECUR),
    ("unsorted ids, tile-aligned recurrence D=128", (2, 384, 384, 8, 4, 128),
     True, torch.bfloat16, SPANS_ALIGNED),
]
# the segment branch under dropout 0.1 (the SEG and DROP instantiations)
SEG_DROPOUT_CASES = [
    ("unsorted ids, ids 3 and 1 recur", (2, 384, 384, 8, 2, 64), True,
     torch.bfloat16, SPANS_RECUR),
    ("tile-aligned 128/128/64/192", (2, 512, 512, 8, 8, 128), False,
     torch.bfloat16, [128, 128, 64, 192]),
    ("packed varlen", (2, 1024, 1024, 8, 2, 64), True, torch.bfloat16,
     packed_lengths(1024, seed=6)),
    ("pad to tile S=577", (4, 577, 577, 16, 16, 64), False, torch.bfloat16,
     "pad"),
    ("f32 [0]*100 + [1]*156 D=128", (1, 256, 256, 4, 4, 128), True,
     torch.float32, [100, 156]),
]
# (name, (B, S, S, Hq, Hkv, D), dtype, segment lengths) of the masks read
# out of the segment and dropout kernels, causal and not (at D 160 the
# wgmma dK/dV's output panels split over two blocks)
SEG_MASK_READOUTS = [
    ("bf16 D=64 unsorted tile-aligned ids, id 3 recurs",
     (2, 256, 256, 8, 2, 64), torch.bfloat16, SPANS_READOUT),
    ("bf16 D=64 GQA 8:2 segments 37/100/63", (2, 200, 200, 8, 2, 64),
     torch.bfloat16, [37, 100, 63]),
    ("bf16 D=160 segments 37/100/63", (1, 200, 200, 4, 4, 160),
     torch.bfloat16, [37, 100, 63]),
    ("f32 D=128 segments 100/156", (1, 256, 256, 4, 4, 128), torch.float32,
     [100, 156]),
]


def phase_segment_kernels(fa, worst):
    """Phase 2d: every bf16 segment launch of rows 3/5/6 takes a wgmma
    body (``kernel_body``, at every head width of phase 2e and D 64 / 128,
    with and without dropout); the segment branch of rows 3/5/6 against
    the plain versions over ``SEG_ATTN_CASES`` and, at dropout 0.1,
    ``SEG_DROPOUT_CASES``; the masks read out of the kernels with segments
    (every kept score inside its segment, every bit ``dropout_keep``'s);
    and the op's pad path end to end at S 577, f32, output and gradients
    against ``flash_attention_ref``.  The worst absolute errors go into
    ``worst`` under the segment rows' keys."""
    dims = sorted({64, 128, *HEAD_DIMS_2E})
    for d in dims:
        for drop in (False, True):
            body = launch_bodies(fa, d, True, drop)
            require(set(body.values()) == {"wgmma"},
                    f"bf16 segment launches at D {d}, dropout {drop}: "
                    f"{body}")
    print(f"  every bf16 segment launch of rows 3/5/6 takes a wgmma body at "
          f"head dims {dims}, with and without dropout")
    rows = {d: fa.segment_tiles("bwd_dq", d)[0] for d in dims}
    print(f"  the wgmma dQ's q rows per block (segment_tiles): {rows}; a "
          f"64-row block's two consumers split the output panels (no grid-z "
          f"split)")
    gen = torch.Generator(device="cuda").manual_seed(13)
    attention_checks(fa, gen, SEG_ATTN_CASES, worst, keys=SEG_KEYS)
    attention_checks(fa, gen, SEG_DROPOUT_CASES, worst, DROPOUT_RATE,
                     SEG_KEYS)
    seed = (9 << 32) | 77
    for name, shape, dt, lens in SEG_MASK_READOUTS:
        for causal in (False, True):
            n, kept = check_masks(fa, shape, dt, causal, seed,
                                  seg=segment_ids(lens, shape[0]))
            print(f"  dropout masks read out of o, dq, dk and dv ({name}, "
                  f"causal={causal}): {n:,} scores inside the segments, "
                  f"none outside, every bit equal to dropout_keep; kept "
                  f"{kept:.6f}")
    q, k, v, do = (x.requires_grad_(True) for x in attn_inputs(
        gen, (2, 577, 577, 4, 4, 64), torch.float32))
    out = fa.flash_attention(q, k, v)
    got = (out, *torch.autograd.grad(out, (q, k, v), do))
    ref = fa.flash_attention_ref(q, k, v)
    want = (ref, *torch.autograd.grad(ref, (q, k, v), do))
    for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        held(f"op {what} pad to tile S=577 [2, 577, 4, 64] f32 against "
             f"flash_attention_ref", g.detach(), w.detach(),
             TRAIN_TOL[torch.float32])
    del q, k, v, do, out, got, ref, want
    torch.cuda.empty_cache()


# -- phase 3: serving at 7B widths -------------------------------------------
def traffic(vocab):
    """8 requests: prompts of 64-1024 tokens, two sharing a 512-token
    prefix (the second one is queued behind the first four, so it arrives
    after the first has finished its prefill), 32-64 new tokens each."""
    r = np.random.default_rng(0)

    def toks(n):
        return r.integers(1, vocab, n).astype(np.int32)

    prefix = toks(512)
    return [(np.concatenate([prefix, toks(100)]), 48), (toks(64), 64),
            (toks(1024), 32), (toks(200), 40), (toks(128), 56),
            (np.concatenate([prefix, toks(200)]), 48), (toks(300), 32),
            (toks(96), 64)]


def model_function_checks(cfg, params):
    """Finite logits of the expected shape from the model functions."""
    from paddle_tpu_torch.models.llama import build_llama_paged_decode

    init_pages, _, prefill_chunk, decode_step, _ = build_llama_paged_decode(
        cfg, page_size=16, num_pages=8, dtype=torch.bfloat16, device="cuda")
    pages = init_pages()
    ids = torch.randint(1, cfg.vocab_size, (1, 64), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3), dtype=torch.int32)
    row = torch.arange(8, dtype=torch.int32, device="cuda")
    logits, tok, _, _ = prefill_chunk(params, ids, 0, 64, row, pages["k"],
                                      pages["v"])
    require(logits.shape == (cfg.vocab_size,)
            and bool(torch.isfinite(logits).all()), "prefill logits finite")
    logits, _, _ = decode_step(
        params, tok.reshape(1), torch.tensor([64], dtype=torch.int32,
                                             device="cuda"),
        row[None], pages["k"], pages["v"],
        torch.tensor([True], device="cuda"))
    require(logits.shape == (1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), "decode logits finite")


def require_graphs(eng, verify=False):
    """The engine's decode horizons (and verify step) ran as captured CUDA
    graphs."""
    runs = list(eng._horizon_runs.values())
    if verify:
        runs.append(eng._verify_run)
    require(runs and all(r is not None and r.graph is not None
                         for r in runs),
            f"dispatches captured as CUDA graphs: {eng.jit_variants()}")


def phase_serving(pa, cfg, params, overlap=False, want=None):
    """3a: the bf16 engine serves ``traffic``; with ``overlap`` the same
    traffic through ``overlap=True``, whose greedy streams must equal
    ``want`` (3a's synchronous streams)."""
    from paddle_tpu_torch.inference.paged import ServingEngine

    eng = ServingEngine(params, cfg, num_slots=4, page_size=16,
                        num_pages=320, max_pages_per_seq=72,
                        dtype=torch.bfloat16, prompt_bucket=32,
                        decode_horizon=8, prefill_chunk=256, overlap=overlap,
                        device="cuda")
    # warm-up (cuBLAS handles, allocator, kernel load, the graphs'
    # captures): one dense and one chunked prefill, a few horizons
    warm = np.random.default_rng(1)
    for n in (64, 300):
        eng.submit(warm.integers(1, cfg.vocab_size, n), max_new_tokens=9)
    eng.run()
    torch.cuda.synchronize()

    reqs = traffic(cfg.vocab_size)
    base = eng.stats()
    reset_counts(pa)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, quant_launches, ref_calls = counts(pa)
    st = eng.stats()
    delta = {k: st[k] - base[k] for k in st}

    out = [done[r] for r in rids]
    for (p, m), rq in zip(reqs, out):
        require(len(rq.generated) == m, f"request {rq.rid} finished with "
                f"{len(rq.generated)} of {m} tokens")
        require(all(0 <= t < cfg.vocab_size for t in rq.generated),
                f"request {rq.rid} token ids in range")
    require(out[5].cached_prefix_tokens >= 512,
            f"the shared-prefix request attached "
            f"{out[5].cached_prefix_tokens} cached tokens (want >= 512)")
    L = cfg.num_hidden_layers
    dispatches = delta["decode_model_steps"] + delta["prefill_chunks"]
    require(launches == L * dispatches and launches > 0,
            f"kernel launches {launches} (graph replays included) != "
            f"layers x attention dispatches {L} x {dispatches}")
    require(ref_calls == 0 and quant_launches == 0,
            f"plain version ran {ref_calls} times, quantized kernel "
            f"{quant_launches}")
    combines = pa.ragged_paged_attention.combine_launches
    require(0 < combines <= launches, f"split merges {combines} (want 1 to "
            f"{launches}: one after each split launch)")
    require_graphs(eng)
    eng.check_invariants()
    streams = [list(r.generated) for r in out]
    if overlap:
        require(delta["overlap_steps"] > 0, "the pipeline never overlapped")
        require(streams == want, "overlap=True changed 3a's greedy streams")

    n_tok = sum(len(r.generated) for r in out)
    ttft = np.array([r.ttft for r in out]) * 1e3
    print(f"  requests {len(out)} in 4 slots, tokens {n_tok}, wall "
          f"{wall:.3f} s, {n_tok / wall:.1f} tokens/s")
    print(f"  TTFT p50 {np.percentile(ttft, 50):.1f} ms, p95 "
          f"{np.percentile(ttft, 95):.1f} ms (all submitted at t=0)")
    print(f"  engine counters: {json.dumps(delta)}")
    print(f"  kernel launches {launches} (= {L} layers x ("
          f"{delta['decode_model_steps']} decode steps + "
          f"{delta['prefill_chunks']} chunks), graph replays included), "
          f"plain-version calls {ref_calls}, split merges {combines}; "
          f"captured graphs {eng.jit_variants()}")
    if overlap:
        print("  greedy streams equal to the synchronous engine's: True")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    step = decode_breakdown(eng, cfg)
    return dict(launches=launches, combines=combines, tokens=n_tok,
                wall_s=wall, streams=streams, step=step, engine=eng,
                kv_bytes=eng.pool.num_pages * eng.page_bytes,
                tokens_per_s=n_tok / wall,
                ttft_p50_ms=float(np.percentile(ttft, 50)),
                ttft_p95_ms=float(np.percentile(ttft, 95)),
                decode_kv_lens=[len(reqs[i][0]) + reqs[i][1] // 2
                                for i in range(4)])


def serving_turns(cfg, serve, serve_o):
    """3a's traffic again through the synchronous engine and the
    overlapped one, in turns (synchronous, overlap, overlap, synchronous),
    each from an empty prefix cache: tokens/s and TTFT of each turn, the
    streams held to 3a's."""
    reqs = traffic(cfg.vocab_size)
    out = {False: [], True: []}
    for sv in (serve, serve_o, serve_o, serve):
        eng = sv["engine"]
        eng.release_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require([done[r].generated for r in rids] == serve["streams"],
                "a turn changed 3a's greedy streams")
        ttft = np.array([done[r].ttft for r in rids]) * 1e3
        out[eng.overlap].append((sum(m for _, m in reqs) / wall,
                                 np.percentile(ttft, 50),
                                 np.percentile(ttft, 95)))
    for overlap, turns in out.items():
        print(f"  overlap={overlap}: " + "; ".join(
            f"{t:.1f} tokens/s, TTFT p50 {p50:.1f} / p95 {p95:.1f} ms"
            for t, p50, p95 in turns))
    return out


# the runtime calls by which the host puts work on the card
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")


def timed_steps(eng, steps):
    """Host wall time of ``steps`` engine steps, then the same number under
    torch.profiler: the device time of their kernels in ms (graph replays'
    kernels included: CUPTI reports each by name), split into the
    attention kernels, matrix products and the rest, the kernel count, and
    the host's launch calls (kernel launches, graph launches, copies)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    groups = {"attention": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = host = 0
    for ev in prof.key_averages():
        if ev.key in LAUNCH_APIS:
            host += ev.count
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if not dev_us or ev.key.startswith(("cuda", "aten::")):
            continue
        kernels += ev.count
        key = ev.key.lower()
        g = "attention" if "ragged_paged_attention" in key else \
            "matmul" if any(s in key for s in ("gemm", "gemv", "cutlass",
                                               "sm90_xmma", "nvjet")) \
            else "other"
        groups[g] += dev_us / 1e3
    require(groups["attention"] > 0 and host > 0,
            f"the profile saw the attention kernels and the host's launches "
            f"({groups}, {host} launch calls)")
    return wall, groups, kernels, host


def print_breakdown(what, eng, wall, n, groups, kernels, host):
    busy = sum(groups.values())
    weights = sum(t.numel() * t.element_size()
                  for tree in eng.params for t in tree.values())
    per = {k: v / n for k, v in groups.items()}
    print(f"  {what}: wall {wall / n * 1e3:.2f} ms unprofiled, device busy "
          f"{busy / n:.2f} ms ({busy / (wall * 1e3) * 100:.1f}%: attention "
          f"{per['attention']:.3f}, matmul {per['matmul']:.3f}, other "
          f"{per['other']:.3f} ms), {kernels / n:.0f} kernels and "
          f"{host / n:.2f} host launch calls per step; weight bytes bound "
          f"{weights / HBM_BYTES_PER_S * 1e3:.2f} ms")
    return dict(wall_ms=wall / n * 1e3, device_ms=busy / n,
                busy=busy / (wall * 1e3), kernels=kernels / n,
                host_launches=host / n)


def decode_breakdown(eng, cfg, steps=2):
    """Where a decode step's time goes: four slots of 512-token contexts,
    pure decode horizons (K = 8 steps each) — first timed on the host
    clock, then the same number under torch.profiler for the device time
    of their kernels.  Per decode model step (one of the K)."""
    r = np.random.default_rng(4)
    for _ in range(4):
        eng.submit(r.integers(1, cfg.vocab_size, 512),
                   max_new_tokens=1 + eng.decode_horizon * (2 * steps + 3))
    eng.step()                      # admissions: the first prefill chunks
    eng.step()                      # the second chunks, the first horizon
    n0, c0 = eng.decode_model_steps, eng.prefill_chunks
    wall, groups, kernels, host = timed_steps(eng, steps)
    n = (eng.decode_model_steps - n0) // 2
    require(n == steps * eng.decode_horizon and eng.prefill_chunks == c0,
            "the timed windows ran pure decode horizons")
    eng.run()
    return print_breakdown(f"decode step ({eng.num_slots} slots, 512-token "
                           f"contexts)", eng, wall, n, groups, kernels, host)


def verify_breakdown(eng, cfg, succ, steps=2):
    """The same for a verify step of the speculative engine: four slots of
    512-token contexts whose prompts hold 64 tokens of the greedy path, so
    every step verifies four drafts per slot (five tokens each when all
    are accepted)."""
    r = np.random.default_rng(9)
    for _ in range(4):
        x = int(r.integers(1, cfg.vocab_size))
        eng.submit(np.concatenate([r.integers(1, cfg.vocab_size, 447),
                                   path(succ, x, 64), [x]]),
                   max_new_tokens=48)
    eng.step()                      # admissions: the first prefill chunks
    eng.step()                      # the second chunks, the first verify
    v0, t0, c0 = eng.verify_steps, eng.tokens_generated, eng.prefill_chunks
    wall, groups, kernels, host = timed_steps(eng, steps)
    require(eng.verify_steps - v0 == 2 * steps and eng.prefill_chunks == c0,
            "the timed windows ran verify steps only")
    tokens = (eng.tokens_generated - t0) / (2 * steps)
    eng.run()
    return print_breakdown(f"verify step ({eng.num_slots} slots, 512-token "
                           f"contexts, {tokens:.1f} tokens per step)", eng,
                           wall, steps, groups, kernels, host)


def successor_model(params, seed):
    """Turn ``(ep, bp, hp)`` IN PLACE into a model whose greedy continuation
    of token t is SUCC[t] by a wide margin: block weights x0.15, the
    embedding x50 so that it dominates the residual stream through every
    layer, and the LM head the embedding of the vocabulary permuted by
    SUCC's inverse.  Returns SUCC.  Every layer still runs at full width on
    real data; only the answer becomes known in advance."""
    ep, bp, hp = params
    vocab = ep["tok"].shape[0]
    succ = np.random.default_rng(seed).permutation(vocab)
    for k, v in bp.items():
        if k.startswith("w"):
            v.mul_(0.15)
    ep["tok"].mul_(50.0)
    inv = torch.as_tensor(np.argsort(succ), device=ep["tok"].device)
    hp["lm"] = ep["tok"][inv].T.contiguous()
    return succ


def path(succ, t, n):
    """n tokens of the successor model's greedy path from t."""
    out = [int(t)]
    for _ in range(n - 1):
        out.append(int(succ[out[-1]]))
    return out


def spec_traffic(vocab, succ):
    """8 requests whose prompts repeat a stretch of the model's greedy path:
    random tokens, the stretch from x, 8 random tokens, then x again — so
    from its first decode step on the n-gram index proposes the stretch and
    the drafts are accepted until the stretch runs out.  Two share a
    512-token prefix, one is chunked four ways; 32-64 new tokens each."""
    r = np.random.default_rng(6)

    def prompt(n, stretch):
        x = int(r.integers(1, vocab))
        return np.concatenate([r.integers(1, vocab, n - stretch - 9),
                               path(succ, x, stretch),
                               r.integers(1, vocab, 8), [x]]).astype(np.int32)

    first = prompt(612, 32)
    return [(first, 48), (prompt(64, 24), 64), (prompt(1024, 40), 32),
            (prompt(200, 30), 40), (prompt(128, 48), 56),
            (np.concatenate([first[:512], prompt(200, 30)]), 48),
            (prompt(300, 36), 32), (prompt(96, 24), 64)]


def phase_serving_quant(pa, cfg, params, kv_bytes):
    """The int8-KV + speculative=4 engine at 7B widths, its pool holding the
    same KV bytes as phase 3a's."""
    from paddle_tpu_torch.inference.paged import ServingEngine
    from paddle_tpu_torch.serving.quant import page_bytes

    succ = successor_model(params, seed=7)
    num_pages = kv_bytes // page_bytes(cfg, 16, kv_dtype="int8")
    eng = ServingEngine(params, cfg, num_slots=4, page_size=16,
                        num_pages=num_pages, max_pages_per_seq=72,
                        dtype=torch.bfloat16, prompt_bucket=32,
                        decode_horizon=8, prefill_chunk=256,
                        kv_dtype="int8", speculative=4, device="cuda")
    require(eng._pages_k["q"].dtype == torch.int8, "int8 page store")
    print(f"  pool {num_pages} int8 pages x {eng.page_bytes} B = "
          f"{num_pages * eng.page_bytes / 1e9:.3f} GB (phase 3a: "
          f"{kv_bytes / 1e9:.3f} GB)")
    r = np.random.default_rng(8)
    for n in (64, 300):                   # warm-up: dense + chunked prefill
        x = int(r.integers(1, cfg.vocab_size))
        eng.submit(np.concatenate([r.integers(1, cfg.vocab_size, n - 13),
                                   path(succ, x, 12), [x]]),
                   max_new_tokens=17)
    eng.run()
    torch.cuda.synchronize()

    reqs = spec_traffic(cfg.vocab_size, succ)
    base = eng.stats()
    reset_counts(pa)
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, quant_launches, ref_calls = counts(pa)
    st = eng.stats()
    delta = {k: st[k] - base[k] for k in st if k != "draft_accept_rate"}
    out = [done[r] for r in rids]
    for (p, m), rq in zip(reqs, out):
        require(rq.generated == path(succ, succ[p[-1]], m),
                f"request {rq.rid}: the tokens leave the model's greedy path")
    require(out[5].cached_prefix_tokens >= 512,
            f"the shared-prefix request attached "
            f"{out[5].cached_prefix_tokens} cached tokens (want >= 512)")
    L = cfg.num_hidden_layers
    dispatches = delta["decode_model_steps"] + delta["verify_steps"] \
        + delta["prefill_chunks"]
    require(quant_launches == L * dispatches,
            f"quantized kernel launches {quant_launches} != layers x "
            f"attention dispatches {L} x {dispatches}")
    require(launches == 0 and ref_calls == 0,
            f"plain kernel ran {launches} times, plain version {ref_calls}")
    combines = pa.ragged_paged_attention.combine_launches
    require(0 < combines <= quant_launches, f"split merges {combines} (want 1"
            f" to {quant_launches}: one after each split launch)")
    require(delta["verify_steps"] > 0 and delta["draft_tokens_proposed"] > 0,
            "no draft was proposed and verified")
    require_graphs(eng, verify=True)
    eng.check_invariants()

    n_tok = sum(len(r.generated) for r in out)
    ttft = np.array([r.ttft for r in out]) * 1e3
    acc = delta["draft_tokens_accepted"] / delta["draft_tokens_proposed"]
    print(f"  requests {len(out)} in 4 slots, tokens {n_tok}, wall "
          f"{wall:.3f} s, {n_tok / wall:.1f} tokens/s; every request on "
          f"the model's greedy path")
    print(f"  TTFT p50 {np.percentile(ttft, 50):.1f} ms, p95 "
          f"{np.percentile(ttft, 95):.1f} ms (all submitted at t=0)")
    print(f"  drafts proposed {delta['draft_tokens_proposed']}, accepted "
          f"{delta['draft_tokens_accepted']} (acceptance {acc:.3f}) in "
          f"{delta['verify_steps']} verify steps")
    print(f"  engine counters: {json.dumps(delta)}")
    print(f"  quantized kernel launches {quant_launches} (= {L} layers x ("
          f"{delta['decode_model_steps']} decode steps + "
          f"{delta['verify_steps']} verify steps + {delta['prefill_chunks']}"
          f" chunks), graph replays included), plain kernel {launches}, "
          f"plain version {ref_calls}, split merges {combines}; captured "
          f"graphs {eng.jit_variants()}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")
    step = verify_breakdown(eng, cfg, succ)
    return dict(quant_launches=quant_launches, combines=combines, succ=succ,
                tokens_per_s=n_tok / wall, step=step,
                ttft_p50_ms=float(np.percentile(ttft, 50)),
                ttft_p95_ms=float(np.percentile(ttft, 95)), acceptance=acc,
                decode_kv_lens=[len(reqs[i][0]) + reqs[i][1] // 2
                                for i in range(4)])


def lifecycle_traffic(vocab, succ):
    """4 requests of 100-300 prompt tokens, 40-64 new tokens each, and
    what the successor model emits for each: its greedy path."""
    r = np.random.default_rng(12)
    reqs = [(r.integers(1, vocab, n).astype(np.int32), m)
            for n, m in ((100, 64), (300, 40), (180, 56), (240, 48))]
    return [(p, m, path(succ, succ[p[-1]], m)) for p, m in reqs]


def phase_lifecycle(cfg, params, succ):
    """3i: the request lifecycle at 7B widths on the successor model, two
    ``overlap=True`` engines sharing the weights: a snapshot taken with a
    dispatch in flight restores into the second engine and continues; a
    mid-decode request moves by ``export_kv`` / ``import_kv``; a cancel and
    a ``timeout=0.0`` act while a dispatch is in flight.  Every stream must
    be the model's greedy path, the page accounting exact, every page must
    come back, and no pool tensor may move."""
    from paddle_tpu_torch.inference.paged import ServingEngine

    def engine():
        return ServingEngine(params, cfg, num_slots=4, page_size=16,
                             num_pages=96, max_pages_per_seq=24,
                             dtype=torch.bfloat16, prompt_bucket=32,
                             decode_horizon=8, prefill_chunk=256,
                             overlap=True, device="cuda")

    def ptrs(eng):
        return [t.data_ptr() for t in (eng._pages_k, eng._pages_v)]

    reqs = lifecycle_traffic(cfg.vocab_size, succ)
    a, b = engine(), engine()
    pa0, pb0 = ptrs(a), ptrs(b)
    t0 = time.perf_counter()
    rids = [a.submit(p, max_new_tokens=m) for p, m, _ in reqs]
    for _ in range(4):
        a.step()
    require(a.inflight_depth == 1, "a dispatch in flight at the snapshot")
    state = a.snapshot()
    require(b.restore(state) == "full_kv", "full-KV restore")
    done = b.run()
    for rid, (_, _, want) in zip(rids, reqs):
        require(done[rid].generated == want,
                f"request {rid}: restored stream leaves the greedy path")
    for rid in rids:                      # the source drops its copies
        a.cancel(rid)
    print(f"  snapshot with a dispatch in flight ({len(state['kv_pages'])} "
          f"pages, {sum(v.nbytes for v in state.values() if hasattr(v, 'nbytes')) / 1e6:.1f}"
          f" MB) -> restore -> {len(rids)} streams on the greedy path")

    p, m, want = reqs[1]
    rid = a.submit(p, max_new_tokens=m)
    while len(a.lookup(rid).generated) < 9:
        a.step()
    packet = a.export_kv([rid])
    a.cancel(rid)
    rid2 = b.import_kv(packet)[rid]
    got = b.run()[rid2].generated
    require(got == want, "imported request leaves the greedy path")
    print(f"  export_kv at token {len(packet['requests'][0]['req']['generated'])}"
          f" ({len(packet['kv_pages'])} pages, {packet['bytes'] / 1e6:.1f} "
          f"MB) -> import_kv -> continued on the greedy path")

    rids = [a.submit(p, max_new_tokens=m) for p, m, _ in reqs[:3]]
    a.step()
    a.step()
    late = a.submit(reqs[3][0], max_new_tokens=reqs[3][1], timeout=0.0)
    a.step()
    require(a.inflight_depth == 1 and a.lookup(late).timed_out,
            "the overdue request timed out with a dispatch in flight")
    require(a.cancel(rids[0]), "cancel found the request")
    require(a.inflight_depth == 0, "cancel quiesced the pipeline")
    done = a.run()
    require(rids[0] not in done and done[late].timed_out
            and a.stats()["timeouts"] >= 1, "cancel and timeout outcomes")
    for rid, (_, _, want) in zip(rids[1:], reqs[1:3]):
        require(done[rid].generated == want,
                f"request {rid}: a survivor leaves the greedy path")
    for eng, p0 in ((a, pa0), (b, pb0)):
        eng.check_invariants()
        eng.release_cache()
        require(eng.pool.num_free == eng.pool.num_pages,
                "every page came back")
        require(ptrs(eng) == p0, "the page pools never moved")
        require_graphs(eng)
    torch.cuda.synchronize()
    print(f"  cancel and timeout=0.0 with a dispatch in flight: cancelled "
          f"request dropped, the overdue one timed out, survivors on the "
          f"greedy path; invariants hold, every page back, pools unmoved "
          f"({time.perf_counter() - t0:.1f} s)")


# -- phase 3k: telemetry, fault points and durable snapshots -----------------
def telemetry_engine(cfg, params, device="cuda", **kw):
    """An engine of phase 3a's geometry (4 slots, 320 pages of 16, bf16,
    horizons of 8, chunks of 256)."""
    from paddle_tpu_torch.inference.paged import ServingEngine
    return ServingEngine(params, cfg, **dict(dict(
        num_slots=4, page_size=16, num_pages=320, max_pages_per_seq=72,
        dtype=torch.bfloat16, prompt_bucket=32, decode_horizon=8,
        prefill_chunk=256, device=device), **kw))


def device_sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warm_engine(eng, vocab):
    """3a's warm-up: a dense and a chunked prefill, a few horizons (the
    decode graph's capture)."""
    warm = np.random.default_rng(1)
    for n in (64, 300):
        eng.submit(warm.integers(1, vocab, n), max_new_tokens=9)
    eng.run()
    device_sync(eng.device)


def on_path(succ, reqs, streams, what):
    """Every stream is the successor model's greedy path from its prompt."""
    for (p, m), got in zip(reqs, streams):
        require(list(got) == path(succ, succ[p[-1]], m),
                f"{what}: a stream left the model's greedy path")


def serve_turn(eng, reqs, count_syncs=False):
    """``reqs`` through ``eng`` from an empty prefix cache: (streams, wall
    seconds, synchronising calls or None).  With ``count_syncs`` the run is
    under ``torch.cuda.set_sync_debug_mode("warn")`` and the calls that
    warn are counted (not the mode's own notice, which the first switch-on
    of a process prints: "Synchronization debug mode is a prototype
    feature ...")."""
    import warnings
    eng.release_cache()
    device_sync(eng.device)
    syncs = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
            done = eng.run()
            if count_syncs:
                torch.cuda.set_sync_debug_mode(0)
            device_sync(eng.device)
            wall = time.perf_counter() - t0
        finally:
            if count_syncs:
                torch.cuda.set_sync_debug_mode(0)
    if count_syncs:
        syncs = sum("synchroniz" in str(w.message)
                    and "debug mode" not in str(w.message) for w in caught)
    return [list(done[r].generated) for r in rids], wall, syncs


def telemetry_on_off(cfg, params, succ, overlap, card):
    """3k (a): 3a's traffic through a telemetry-off and a telemetry-on
    engine in turns (off, on, on, off), each pass under
    ``torch.cuda.set_sync_debug_mode("warn")``: equal streams (the greedy
    path), equal ``jit_variants()``, equal synchronising calls in every
    pass, tokens/s of each turn, and the on engine's reports over its last
    turn."""
    from paddle_tpu_torch.observability import Telemetry
    reqs = traffic(cfg.vocab_size)
    off = telemetry_engine(cfg, params, overlap=overlap)
    tel = Telemetry()
    on = telemetry_engine(cfg, params, overlap=overlap, telemetry=tel)
    for eng in (off, on):
        warm_engine(eng, cfg.vocab_size)
    tps = {"off": [], "on": []}
    syncs = []
    for name, eng in (("off", off), ("on", on), ("on", on), ("off", off)):
        if eng is on:
            tel.reset_window()
        streams, wall, n = serve_turn(eng, reqs, count_syncs=True)
        on_path(succ, reqs, streams, f"3k overlap={overlap} telemetry {name}")
        tps[name].append(sum(m for _, m in reqs) / wall)
        syncs.append(n)
    require(len(set(syncs)) == 1 and syncs[0] > 0,
            f"telemetry changed the synchronising calls, or the debug mode "
            f"counted none (the prefills' pageable copies synchronise): off, "
            f"on, on, off {syncs}")
    require(on.jit_variants() == off.jit_variants(),
            f"jit_variants differ: {on.jit_variants()} / "
            f"{off.jit_variants()}")
    require_graphs(on)
    require_graphs(off)
    snap = tel.registry.snapshot()
    ttft, tpot = snap["serve.ttft_s"], snap["serve.tpot_s"]
    require(ttft["count"] == len(reqs) and tpot["count"] == len(reqs),
            f"histogram counts {ttft['count']} / {tpot['count']}")
    util = tel.utilization_report(window_s=sum(m for _, m in reqs)
                                  / tps["on"][-1])
    shares = {k: util[k] for k in ("host_busy_frac", "dispatch_frac",
                                   "device_wait_frac", "gap_frac",
                                   "device_idle_frac_est")}
    require(abs(sum(shares[k] for k in ("host_busy_frac", "dispatch_frac",
                                         "device_wait_frac", "gap_frac"))
                - 1.0) < 0.01, f"utilization shares {shares}")
    mem = tel.memory_report()
    comp = tel.compile_report()
    require(comp["total_compiles"] == sum(on.jit_variants().values()),
            f"captures {comp} against {on.jit_variants()}")
    pre = "overlap" if overlap else "decode"
    phases = {k: round(v["total_s"] * 1e3, 2)
              for k, v in util["per_phase"].items()}
    require({f"{pre}_dispatch", f"{pre}_sync", f"{pre}_record",
             "sched"} <= set(phases), f"phases {sorted(phases)}")
    print(f"  overlap={overlap}: greedy streams equal, telemetry on and off "
          f"(the model's greedy path); jit_variants {on.jit_variants()} "
          f"both; synchronising calls a pass (off, on, on, off): {syncs}")
    print(f"    tokens/s in turns: off {tps['off'][0]:.1f}, on "
          f"{tps['on'][0]:.1f}, on {tps['on'][1]:.1f}, off "
          f"{tps['off'][1]:.1f} on {card}")
    print(f"    telemetry (last on turn): TTFT p50 {ttft['p50'] * 1e3:.1f} / "
          f"p95 {ttft['p95'] * 1e3:.1f} ms, TPOT p50 "
          f"{tpot['p50'] * 1e3:.2f} ms; utilization {json.dumps(shares)}; "
          f"phase ms {json.dumps(phases)}")
    print(f"    memory: peak occupancy {mem['peak_occupancy_frac']}, min free "
          f"pages {mem['min_free_pages']}, device bytes "
          f"{mem['last'].get('device_bytes_in_use')}; captures "
          f"{comp['total_compiles']} ({json.dumps(comp['per_fn'])}), wall "
          f"{comp['compile_s_total']:.3f} s")
    out = dict(tps=tps, syncs=syncs, ttft_p50_ms=ttft["p50"] * 1e3,
               ttft_p95_ms=ttft["p95"] * 1e3, tpot_p50_ms=tpot["p50"] * 1e3,
               shares=shares, peak_occupancy=mem["peak_occupancy_frac"],
               compiles=comp)
    del off, on
    return out


# the pool-pressure drill's seed: with it the plan fires on a decode step
# where every slot is short of a page, so the ladder reaches preemption (the
# schedule is the greedy path's, the same at any width)
PRESSURE_SEED = 4


def fault_drills(cfg, params, succ, seed=PRESSURE_SEED):
    """3k (b): on an int8-KV engine with telemetry, a seeded
    ``serve.pool_pressure`` plan (prob 0.4, 6 fires), a ``pagepool.alloc``
    trigger and a ``serve.wedge`` step."""
    from paddle_tpu_torch.observability import Telemetry
    from paddle_tpu_torch.resilience import inject
    tel = Telemetry(flight_capacity=8192)
    eng = telemetry_engine(cfg, params, kv_dtype="int8", telemetry=tel)
    reqs = traffic(cfg.vocab_size)
    with inject({"serve.pool_pressure": dict(action="trigger", prob=0.4,
                                             count=6)}, seed=seed) as plan:
        rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        done = eng.run()
    on_path(succ, reqs, [done[r].generated for r in rids],
            "3k pool pressure")
    names = tel.flight.event_names()
    require(plan.fired() >= 1 and eng.preemptions >= 1,
            f"pressure fired {plan.fired()}, preemptions {eng.preemptions}")
    ladder = [names.index(n) for n in ("submit", "admit", "evict",
                                       "preempt")]
    require(ladder == sorted(ladder), f"flight ladder order {ladder}")
    dumps = sum(d["reason"] == "injected_fault" for d in tel.flight.dumps)
    eng.check_invariants()
    eng.release_cache()
    require(eng.pool.num_free == eng.pool.num_pages, "every page came back")
    print(f"  serve.pool_pressure (seed {seed}, prob 0.4, count 6: "
          f"{plan.fired()} fires in {plan.hits()} consults): {len(rids)} "
          f"streams on the greedy "
          f"path, {eng.preemptions} preemptions, {eng.cache_evictions} "
          f"evictions, {dumps} flight dumps; the ladder submit -> admit -> "
          f"evict -> preempt at ring events {ladder}; every page back")

    p, m = reqs[1]
    with inject({"pagepool.alloc": dict(action="trigger", at=0)}) as plan:
        rid = eng.submit(p, max_new_tokens=m)
        try:
            eng.step()
            raise RuntimeError("chip_smoke: pagepool.alloc did not fire")
        except RuntimeError as e:
            require("exhausted (injected)" in str(e), f"alloc fault: {e}")
    eng.check_invariants()
    on_path(succ, [(p, m)], [eng.run()[rid].generated], "3k alloc fault")
    s0 = eng.stats()
    rid = eng.submit(p, max_new_tokens=m)
    with inject({"serve.wedge": dict(action="trigger", at=0,
                                     match={"engine": eng.name})}):
        progressed = eng.step()
    require(not progressed and eng.stats() == s0
            and tel.flight.events()[-2]["point"] == "serve.wedge",
            "a wedged step did work")
    on_path(succ, [(p, m)], [eng.run()[rid].generated], "3k after wedge")
    eng.check_invariants()
    eng.release_cache()
    require(eng.pool.num_free == eng.pool.num_pages, "every page came back")
    print("  pagepool.alloc trigger: the admission raised the injected "
          "exhaustion, no reference leaked, the request then served on the "
          "greedy path; serve.wedge: the step returned no progress with "
          "every counter unchanged")
    return eng.stats()


def durable_snapshots(cfg, params, succ, root):
    """3k (b) crash and (c): an overlap=True bf16 engine with telemetry
    serves phase 3i's traffic; a full-KV ``save_engine`` with a dispatch in
    flight; a second save torn by ``serve.snapshot`` trigger and a third
    killed by ``ckpt.commit``, after each of which the first stays the
    newest intact snapshot; then a ``serve.crash`` raise mid-step, its
    flight dump written to a file, and a fresh engine restored through
    ``restore_engine`` continues every stream on the greedy path."""
    from paddle_tpu_torch.observability import Telemetry
    from paddle_tpu_torch.resilience import InjectedFault, inject
    from paddle_tpu_torch.serving import EngineSnapshotManager
    dump_path = os.path.join(root, "flight.jsonl")
    tel = Telemetry(flight_dump_path=dump_path)
    eng = telemetry_engine(cfg, params, num_pages=96, max_pages_per_seq=24,
                           overlap=True, telemetry=tel)
    reqs = [(p, m) for p, m, _ in lifecycle_traffic(cfg.vocab_size, succ)]
    mgr = EngineSnapshotManager(os.path.join(root, "snapshots"),
                                keep_last=None)
    rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
    for _ in range(4):
        eng.step()
    require(eng.inflight_depth == 1, "a dispatch in flight at the save")
    t0 = time.perf_counter()
    first = mgr.save_engine(eng)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(first, f))
                 for f in os.listdir(first))
    meta = json.load(open(os.path.join(first, "metadata.json")))["tensors"]
    pages = meta["kv_pages"]["shape"][0]
    eng.step()
    with inject({"serve.snapshot": dict(action="trigger", at=0)}):
        torn = mgr.save_engine(eng)
    require(mgr.find_latest_complete() == first and torn != first,
            "the torn snapshot was taken for the newest")
    eng.step()
    with inject({"ckpt.commit": dict(at=0)}):
        try:
            mgr.save_engine(eng)
            raise RuntimeError("chip_smoke: ckpt.commit did not fire")
        except InjectedFault:
            pass
    require(mgr.find_latest_complete() == first,
            "a killed commit displaced the newest intact snapshot")
    with inject({"serve.crash": dict(at=0, match={"phase": "record"})}):
        try:
            eng.run()
            raise RuntimeError("chip_smoke: serve.crash did not fire")
        except InjectedFault as e:
            tel.fault_dump("injected_fault", point="serve.crash",
                           error=str(e)[:200])
    eng.check_invariants()
    with open(dump_path) as f:
        dumps = [json.loads(line) for line in f]
    require(dumps and dumps[-1]["extra"]["point"] == "serve.crash",
            "the crash's flight dump is not in the file")
    crashed_at = eng._step_seq
    del eng
    fresh = telemetry_engine(cfg, params, num_pages=96, max_pages_per_seq=24,
                             overlap=True)
    t0 = time.perf_counter()
    got, applied = mgr.restore_engine(fresh)
    restore_s = time.perf_counter() - t0
    require(got == first and applied == "full_kv", f"restored {got}")
    done = fresh.run()
    on_path(succ, reqs, [done[r].generated for r in rids],
            "3k restored after the crash")
    fresh.check_invariants()
    fresh.release_cache()
    require(fresh.pool.num_free == fresh.pool.num_pages,
            "every page came back")
    print(f"  save_engine (full KV, a dispatch in flight): {pages} pages, "
          f"{nbytes / 2**20:.1f} MiB on disk ({nbytes / pages / 2**20:.2f} "
          f"MiB a page), {save_s:.3f} s; a save torn by serve.snapshot and "
          f"one killed by ckpt.commit left it the newest intact snapshot")
    print(f"  serve.crash at step {crashed_at}: flight dump of "
          f"{len(dumps[-1]['events'])} events written "
          f"({os.path.getsize(dump_path)} B, {len(dumps)} dumps); a fresh "
          f"engine restored in {restore_s:.3f} s ({applied}) continued "
          f"{len(rids)} streams on the greedy path")
    return dict(snapshot_bytes=nbytes, pages=pages, save_s=save_s,
                restore_s=restore_s)


def profiler_bridge(cfg, params):
    """3k (d): under torch.profiler, with ``Telemetry(profiler_bridge=True)``
    the engine's ``serve.decode_dispatch`` host spans enclose its decode
    graph launches."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.observability import Telemetry
    eng = telemetry_engine(cfg, params, num_pages=96, max_pages_per_seq=24,
                           telemetry=Telemetry(profiler_bridge=True))
    warm_engine(eng, cfg.vocab_size)
    r = np.random.default_rng(13)
    for _ in range(4):
        eng.submit(r.integers(1, cfg.vocab_size, 64), max_new_tokens=33)
    eng.step()                                   # the admissions
    n0 = eng.decode_model_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    dispatches = (eng.decode_model_steps - n0) // eng.decode_horizon
    eng.run()
    evs = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    # the host ranges (the trace also mirrors each as a device annotation)
    spans = [e for e in evs if e.name == "serve.decode_dispatch"
             and e.device_type == cpu]
    launches = [e for e in evs if e.name == "cudaGraphLaunch"]
    inside = [e for e in launches if any(
        s.time_range.start <= e.time_range.start
        and e.time_range.end <= s.time_range.end for s in spans)]
    kernels = sum(1 for e in evs if "ragged_paged_attention" in e.name
                  and e.device_type == torch.autograd.DeviceType.CUDA)
    require(len(spans) == dispatches > 0 and len(inside) == len(launches)
            == dispatches and kernels > 0,
            f"bridge spans {len(spans)}, graph launches {len(launches)} "
            f"({len(inside)} inside a span), dispatches {dispatches}, "
            f"attention kernels {kernels}")
    print(f"  profiler bridge: {len(spans)} serve.decode_dispatch spans in "
          f"the torch.profiler trace enclose all {len(launches)} decode "
          f"graph launches; {kernels} ragged-attention kernels on the card "
          f"in the window")


def phase_telemetry(pa, cfg, params, succ, card):
    """3k: the serving engine's telemetry, fault points and durable
    snapshots at 7B widths on the successor model (parts a-d), and the
    phase's launches of rows 1-2 (e)."""
    import shutil
    import tempfile
    reset_counts(pa)
    t_start = time.perf_counter()
    out = {}
    for overlap in (False, True):
        out[overlap] = telemetry_on_off(cfg, params, succ, overlap, card)
        torch.cuda.empty_cache()
    fault_drills(cfg, params, succ)
    root = tempfile.mkdtemp(prefix="chip_smoke_3k_")
    try:
        out["snap"] = durable_snapshots(cfg, params, succ, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    profiler_bridge(cfg, params)
    launches, quant_launches, ref_calls = counts(pa)
    require(launches > 0 and quant_launches > 0 and ref_calls == 0,
            f"3k launches: row 1 {launches}, row 2 {quant_launches}, plain "
            f"version {ref_calls}")
    torch.cuda.empty_cache()
    print(f"  phase 3k launches: row 1 {launches}, row 2 {quant_launches} "
          f"(graph replays included), plain version {ref_calls}; "
          f"{time.perf_counter() - t_start:.1f} s")
    out["launches"] = (launches, quant_launches)
    return out


# -- phase 3c: the train step -------------------------------------------------
def train_config(layers=16):
    """The repo's training model (bench.py bench_llama on the chip): vocab
    32,000, hidden 1,024, MLP 2,816, 16 heads of 64, context 2,048."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=1024,
                       intermediate_size=2816, num_hidden_layers=layers,
                       num_attention_heads=16, num_key_value_heads=16,
                       max_position_embeddings=2048)


def make_train_step(cfg, dtype, kernels, seed=0):
    """bench.py's step: build_functional_llama(n_micro=1, head_chunks=8),
    loss = embed -> L blocks -> chunked head, gradients of every leaf, then
    one AdamW(lr=1e-4, weight_decay=0.01) update per parameter tree.
    Returns (step(batch) -> (loss, grads), trees, n_params)."""
    from paddle_tpu_torch.models.llama import build_functional_llama
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import _flatten

    ep, bp, hp, ea, ba, hl = build_functional_llama(
        cfg, dtype=dtype, n_micro=1, head_chunks=8, device="cuda", seed=seed,
        kernels=kernels)
    trees = (ep, bp, hp)
    leaves = [v.requires_grad_(True) for t in trees for v in t.values()]
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01)
    states = [opt.init_opt_state(_flatten(t), device="cuda") for t in trees]

    def step(batch, marks=None):
        """One step; ``marks`` (4 CUDA events), when given, are recorded
        before the forward, after it, after the backward and after the
        update."""
        mark = (lambda i: marks[i].record()) if marks else (lambda i: None)
        mark(0)
        x = ea(ep, batch)[0]
        for i in range(cfg.num_hidden_layers):
            x = ba({k: v[i] for k, v in bp.items()}, x)
        loss = hl(hp, x[None], batch)
        mark(1)
        grads = torch.autograd.grad(loss, leaves)
        mark(2)
        it = iter(grads)
        for t, st in zip(trees, states):
            opt.apply_gradients_functional(
                _flatten(t), _flatten({k: next(it) for k in t}), st)
        mark(3)
        return loss.detach(), grads

    return step, trees, sum(v.numel() for v in leaves)


def train_batch(cfg, B, S, seed=0):
    """bench.py's batch: random ids, labels = ids."""
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    return ids, ids


def phase_train(pa, B=8, S=2048, warmup=3, steps=10):
    """The 271M train step in bf16 at B x S: warm-up and timed steps with
    the loss of each, tokens/s, the mfu share, peak memory, launches per
    step of rows 3-8 (asserted), then one step under torch.profiler."""
    cfg = train_config()
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    torch.cuda.reset_peak_memory_stats()
    step, _, n_params = make_train_step(cfg, torch.bfloat16, kernels=True)
    batch = train_batch(cfg, B, S)
    losses = []
    for _ in range(warmup):
        losses.append(float(step(batch)[0]))
    torch.cuda.synchronize()
    reset_counts(pa)
    t0 = time.perf_counter()
    out = [step(batch)[0] for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = {k: fn.launches / steps for k, fn in train_wrappers().items()}
    launches = {k: fn.launches for k, fn in train_wrappers().items()}
    paged = counts(pa)
    losses += [float(x) for x in out]
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = dict({k: 0 for k in per_step}, fa_fwd=L, fa_dkv=L, fa_dq=L,
                rms_fwd=2 * L + 1, rms_bwd=2 * L + 1)
    require(per_step == want, f"launches per step {per_step} != {want}")
    require(paged == (0, 0, 0), f"paged attention ran in the train step: "
            f"{paged}")
    from paddle_tpu_torch.ops import flash_attention as fa
    require_bodies(fa, "the attention launches",
                   H // cfg.num_attention_heads, False, False)
    tokens_per_s = B * S * steps / wall
    flop_per_token = 6.0 * n_params + 6.0 * L * S * H
    mfu = flop_per_token * tokens_per_s / BF16_FLOP_PER_S
    peak = torch.cuda.max_memory_allocated()
    print(f"  {n_params / 1e6:.1f}M parameters, B={B} S={S} bf16, "
          f"head_chunks=8, AdamW(lr=1e-4, wd=0.01)")
    print(f"  loss per step ({warmup} warm-up + {steps} timed): "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"  {steps} steps in {wall:.3f} s: {wall / steps * 1e3:.1f} ms per "
          f"step, {tokens_per_s:.1f} tokens/s, mfu_share "
          f"{mfu:.4f} (({flop_per_token / 1e9:.3f} GFLOP per token) x "
          f"tokens/s / 989 TFLOP/s)")
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    print(f"  launches per step: {json.dumps(per_step)} (rows 3/5/6 = {L} "
          f"layers, rows 7/8 = 2 x {L} + 1 norms, row 4 in the forward's "
          f"epilogue)")
    breakdown = train_breakdown(step, batch, wall / steps)
    return dict(launches=launches, tokens_per_s=tokens_per_s, mfu=mfu,
                step_ms=wall / steps * 1e3, peak_gib=peak / 2**30,
                losses=losses, n_params=n_params, breakdown=breakdown)


MATMUL_NAMES = ("gemm", "gemv", "cutlass", "sm90_xmma", "nvjet")
TRAIN_GROUPS = (("fa_fwd", ("fa_fwd_",)),
                ("fa_bwd", ("fa_bwd_dkv_", "fa_bwd_dq_")),
                ("rmsnorm", ("rms_fwd_kernel", "rms_fwd_vec_kernel",
                             "rms_bwd_vec_kernel", "rms_bwd_kernel",
                             "rms_dw_reduce_kernel")),
                ("matmul", MATMUL_NAMES))
ERNIE_GROUPS = (("fa_fwd", ("fa_fwd_",)),
                ("fa_bwd", ("fa_bwd_dkv_", "fa_bwd_dq_")),
                ("layernorm", ("ln_fwd_kernel", "ln_bwd_vec_kernel",
                               "ln_bwd_kernel", "ln_dwb_reduce_kernel")),
                ("adamw", ("adamw_kernel",)),
                ("matmul", MATMUL_NAMES))


def profile_rows(run):
    """``run()`` once under torch.profiler: (kernels, ops, kernel ms).
    ``kernels`` holds a row ((name,), device ms, count) per kernel name,
    ``ops`` a row (names, device ms, launches) per op that launched
    kernels, ``names`` the op's and its callers', innermost first.  The
    profiler hands a kernel to every op event that carries its launch's
    correlation id, and a profiler event of its own ("Activity Buffer
    Request") can run inside an op under the op's id: each id is counted
    once, at its outermost event.  The kernels that no op claims make one
    op row, "(no op)", of the kernels' ms less the ops' (negative if an
    op's kernels were counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels, claims = {}, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            row = kernels.setdefault(ev.name, [0.0, 0])
            row[0] += ev.time_range.elapsed_us() / 1e3
            row[1] += 1
        elif ev.kernels and not ev.is_async:
            claims.setdefault(ev.id, []).append(ev)
    ops = []
    for evs in claims.values():
        ev = min(evs, key=lambda e: (e.time_range.start, -e.time_range.end))
        names, up = [], ev
        while up is not None:
            names.append(up.name)
            up = up.cpu_parent
        ops.append((tuple(names), sum(k.duration for k in ev.kernels) / 1e3,
                    len(ev.kernels)))
    device = sum(ms for ms, _ in kernels.values())
    ops.append((("(no op)",), device - sum(ms for _, ms, _ in ops), 0))
    return ([((n,), ms, k) for n, (ms, k) in kernels.items()], ops, device)


def group_rows(rows, groups_of):
    """Device ms by group of ``rows`` (:func:`profile_rows`): a row goes
    to the group of the first of its names, innermost first, that holds
    one of the group's patterns (the first such group of ``groups_of``),
    else to "other".  Returns the groups and every row as (group, ms,
    count, name)."""
    groups = dict.fromkeys([g for g, _ in groups_of] + ["other"], 0.0)
    named = []
    for names, ms, count in rows:
        g = next((g for n in names for g, pats in groups_of
                  if any(p in n.lower() for p in pats)), "other")
        groups[g] += ms
        named.append((g, ms, count, names[0]))
    return groups, named


def largest(named, group, n=6):
    """The ``n`` rows of ``group`` that took the most device time, as one
    line (from :func:`group_rows`'s list)."""
    return "; ".join(f"{ms:.2f} ms x{k} {key[:90]}" for _, ms, k, key in
                     sorted((x for x in named if x[0] == group),
                            key=lambda x: -x[1])[:n])


def stage_split(step, batch, stages):
    """One unprofiled ``step(batch, marks)`` split into ``stages`` (three)
    by its four CUDA events, printed and returned as {stage: ms}."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    step(batch, marks)
    marks[3].synchronize()
    split = {name: marks[i].elapsed_time(marks[i + 1])
             for i, name in enumerate(stages)}
    print("  one unprofiled step by stage (CUDA events): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()) + " ms")
    return split


def busy_line(busy, step_s, groups, launches):
    """The breakdown's line: device busy ms against an unprofiled step's
    wall time, and the device ms of each group."""
    print(f"  one step under torch.profiler: device busy {busy:.2f} ms of an "
          f"unprofiled {step_s * 1e3:.2f} ms step ("
          f"{busy / (step_s * 1e3) * 100:.1f}%): "
          + ", ".join(f"{g} {v:.2f}" for g, v in groups.items())
          + f" ms; {launches} kernels")


def train_breakdown(step, batch, step_s, groups_of=TRAIN_GROUPS,
                    stages=("forward", "backward", "adamw"), required=None):
    """One train step under torch.profiler: device ms by group of kernel
    name (:func:`group_rows`), the kernel count, and the device busy share
    of an unprofiled step's wall time; before it, one unprofiled step's
    split into ``stages`` by CUDA events.  Each group of ``required``
    (default: every group but matmul) must have seen device time."""
    stages = stage_split(step, batch, stages)
    rows, _, busy = profile_rows(lambda: step(batch))
    groups, named = group_rows(rows, groups_of)
    kernels = sum(k for _, _, k in rows)
    if required is None:
        required = [g for g, _ in groups_of if g != "matmul"]
    require(all(groups[g] > 0 for g in required),
            f"profiler saw no train kernel: {groups}")
    busy_line(busy, step_s, groups, kernels)
    print("  largest 'other' kernels: " + largest(named, "other"))
    return dict(groups, busy_ms=busy, kernels=kernels, **stages)


# -- phase 3d: the ERNIE-base MLM train step ---------------------------------
def ernie_config(layers=12, dropout=DROPOUT_RATE):
    """ERNIE-3.0-base at its published widths (``models/ernie.py``: vocab
    40,000, hidden 768, 12 heads of 64, MLP 3,072, 2,048 positions, 4 token
    types, LayerNorm eps 1e-12) and its published dropout 0.1 on both
    probabilities (``dropout`` sets both)."""
    from paddle_tpu_torch.models import ernie_config_base
    return dataclasses.replace(ernie_config_base(), num_hidden_layers=layers,
                               hidden_dropout_prob=dropout,
                               attention_probs_dropout_prob=dropout)


def make_ernie_step(cfg, dtype, kernels, seed=0, classes=0, lr=1e-4):
    """bench.py's ERNIE MLM loss (``ErnieForMaskedLM(ids, labels=labels)``,
    the chunked head with the decoder bias and ignore_index -100) and one
    AdamW(lr 1e-4, weight_decay 0.01) update of every parameter.  With
    ``kernels`` all three knobs are on (flash attention, the LayerNorm
    kernels, the fused AdamW kernel); without, all three are off.  Every
    parameter gets a gradient, zeros for those the loss never reaches (the
    pooler), as ``jax.value_and_grad`` hands them to the JAX optimizer.
    With ``classes`` the model is ``ErnieForSequenceClassification`` with
    that many classes, its loss the cross-entropy of the logits against the
    batch's labels [B], and ``lr`` its learning rate (fine-tuning).  The
    masks come from the model's generators, seeded from ``seed``.
    Returns (step(batch) -> (loss, grads), params, n_params)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.models import (ErnieForMaskedLM,
                                         ErnieForSequenceClassification)
    from paddle_tpu_torch.optimizer import AdamW

    if classes:
        model = ErnieForSequenceClassification(
            cfg, classes, dtype=dtype, device="cuda", seed=seed,
            kernels=kernels, norm_kernels=kernels)
    else:
        model = ErnieForMaskedLM(cfg, dtype=dtype, device="cuda", seed=seed,
                                 kernels=kernels, norm_kernels=kernels)
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=lr, weight_decay=0.01, fused=kernels)
    state = opt.init_opt_state(params, device="cuda")

    def step(batch, marks=None):
        mark = (lambda i: marks[i].record()) if marks else (lambda i: None)
        ids, labels = batch
        mark(0)
        if classes:
            loss = F.cross_entropy(model(ids).float(), labels.long())
        else:
            loss, _ = model(ids, labels=labels)
        mark(1)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    materialize_grads=True)
        mark(2)
        opt.apply_gradients_functional(params, dict(zip(params, grads)),
                                       state)
        mark(3)
        return loss.detach(), grads

    return step, params, sum(v.numel() for v in params.values())


def phase_ernie(pa, B=64, S=512, warmup=3, steps=10, dropout=DROPOUT_RATE,
                classes=0, lr=1e-4):
    """ERNIE-3.0-base training in bf16 (f32 moments) at B x S with all
    three knobs on and both dropouts at ``dropout``: the MLM step, or with
    ``classes`` the sequence-classification step on random labels.
    Warm-up and timed steps with the loss of each, tokens/s, the mfu share,
    peak memory, launches per step of rows 3/5/6/9/12/13 and of the
    dropout branch of rows 3/5/6 (asserted), no plain version called, the
    stage split and one step under torch.profiler."""
    cfg = ernie_config(dropout=dropout)
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    torch.cuda.reset_peak_memory_stats()
    step, params, n_params = make_ernie_step(cfg, torch.bfloat16, True,
                                             classes=classes, lr=lr)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                           .astype(np.int32)).cuda()
    labels = torch.from_numpy(rng.integers(0, classes, (B,)).astype(
        np.int32)).cuda() if classes else ids
    batch = (ids, labels)
    losses = []
    for _ in range(warmup):
        losses.append(float(step(batch)[0]))
    torch.cuda.synchronize()
    reset_counts(pa)
    with CountPlainCalls() as plain:
        t0 = time.perf_counter()
        out = [step(batch)[0] for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in train_wrappers().items()}
    launches.update(branch_counts())
    per_step = {k: n / steps for k, n in launches.items()}
    losses += [float(x) for x in out]
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    if not classes:
        require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    n_norms = 2 * L + (1 if classes else 2)
    n_drop = L if dropout > 0 else 0
    want = {"fa_fwd": L, "fa_dkv": L, "fa_dq": L, "pack_lse": 0,
            "rms_fwd": 0, "rms_bwd": 0, "adamw": len(params),
            "softmax_fwd": 0, "softmax_bwd": 0, "ln_fwd": n_norms,
            "ln_bwd": n_norms, "fa_fwd_drop": n_drop, "fa_dkv_drop": n_drop,
            "fa_dq_drop": n_drop, "fa_fwd_seg": 0, "fa_dkv_seg": 0,
            "fa_dq_seg": 0}
    require(per_step == want, f"launches per step {per_step} != {want}")
    from paddle_tpu_torch.ops import flash_attention as fa
    require_bodies(fa, "the attention launches", H // cfg.num_attention_heads,
                   False, dropout > 0)
    require(counts(pa) == (0, 0, 0), f"paged attention ran: {counts(pa)}")
    require(not plain.calls, f"plain versions ran: {plain.calls}")
    tokens_per_s = B * S * steps / wall
    flop_per_token = 6.0 * n_params + 6.0 * L * S * H
    mfu = flop_per_token * tokens_per_s / BF16_FLOP_PER_S
    peak = torch.cuda.max_memory_allocated()
    head = f"{classes}-class head, lr {lr:g}" if classes else "MLM"
    print(f"  {n_params:,} parameters in {len(params)} tensors, {head}, "
          f"B={B} S={S} bf16 (f32 moments), dropout {dropout:g} (hidden "
          f"and attention), AdamW(lr={lr:g}, wd=0.01) fused")
    print(f"  loss per step ({warmup} warm-up + {steps} timed): "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"  {steps} steps in {wall:.3f} s: {wall / steps * 1e3:.1f} ms per "
          f"step, {tokens_per_s:.1f} tokens/s, mfu_share {mfu:.4f} "
          f"(({flop_per_token / 1e9:.3f} GFLOP per token) x tokens/s / "
          f"989 TFLOP/s)")
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    print(f"  launches per step: {json.dumps(per_step)} (rows 3/5/6 = {L} "
          f"layers, their dropout branch {n_drop}, row 9 = {len(params)} "
          f"tensors, rows 12/13 = {n_norms} norms); plain-version calls 0")
    breakdown = train_breakdown(step, batch, wall / steps, ERNIE_GROUPS)
    return dict(launches=launches, tokens_per_s=tokens_per_s, mfu=mfu,
                step_ms=wall / steps * 1e3, peak_gib=peak / 2**30,
                losses=losses, n_params=n_params, breakdown=breakdown)


# -- phase 3e: the softmax entry ----------------------------------------------
def phase_softmax_entry():
    """``nn.functional.softmax`` with the norm kernels on at ERNIE's
    attention-probability shape, forward and backward under autograd: one
    launch of each softmax kernel, the results against the kernels' plain
    versions; then an
    untileable last axis (500), ``axis=1`` and the knob off, which take the
    plain op (no launch)."""
    from paddle_tpu_torch.nn.functional import softmax
    from paddle_tpu_torch.ops import fused as fu

    gen = torch.Generator(device="cuda").manual_seed(13)
    x = (2 * torch.randn(SOFTMAX_SHAPE, generator=gen, device="cuda")) \
        .bfloat16().requires_grad_(True)
    g = torch.randn(SOFTMAX_SHAPE, generator=gen, device="cuda").bfloat16()
    for fn in (fu.softmax_fwd, fu.softmax_bwd):
        fn.launches = 0
    with CountPlainCalls() as plain:
        out = softmax(x, norm_kernels=True)
        (dx,) = torch.autograd.grad(out, x, g)
        torch.cuda.synchronize()
    launches = {"softmax_fwd": fu.softmax_fwd.launches,
                "softmax_bwd": fu.softmax_bwd.launches}
    require(launches == {"softmax_fwd": 1, "softmax_bwd": 1},
            f"softmax entry launches {launches}")
    require(not plain.calls, f"plain versions ran: {plain.calls}")
    # the kernels' plain versions on the same bf16 rows: the backward reads
    # the forward's bf16 output, as the kernel's does
    rows = (-1, SOFTMAX_SHAPE[-1])
    ref = fu.softmax_fwd_ref(x.detach().reshape(rows))
    rdx = fu.softmax_bwd_ref(ref, g.reshape(rows))
    held(f"softmax entry o {list(SOFTMAX_SHAPE)} [bfloat16]", out,
         ref.reshape(SOFTMAX_SHAPE), TRAIN_TOL[torch.bfloat16])
    held(f"softmax entry dx {list(SOFTMAX_SHAPE)} [bfloat16]", dx,
         rdx.reshape(SOFTMAX_SHAPE), TRAIN_TOL[torch.bfloat16])
    x500 = torch.randn(8, 12, 64, 500, generator=gen, device="cuda").bfloat16()
    for what, args, kw in (("last axis 500", (x500,), {}),
                           ("axis=1", (x.detach(),), dict(axis=1)),
                           ("knob off", (x.detach(),), dict(norm_kernels=False
                                                            ))):
        kw.setdefault("norm_kernels", True)
        got = softmax(*args, **kw)
        require(fu.softmax_fwd.launches == 1,
                f"softmax entry, {what}: the kernel ran")
        want = torch.softmax(args[0], dim=kw.get("axis", -1))
        require(torch.equal(got, want), f"softmax entry, {what}: not the "
                f"plain op's result")
    print(f"  nn.functional.softmax {list(SOFTMAX_SHAPE)} bf16 forward + "
          f"backward: launches {json.dumps(launches)}, plain-version calls "
          f"0; last axis 500, axis=1 and norm_kernels=False take "
          f"torch.softmax (no launch)")
    return launches


# -- phase 4b: kernel train step == plain train step -------------------------
def phase_train_check(B=8, S=2048):
    """One f32 train step at full width and 2 layers with the kernels and
    one with the plain versions, from the same seeded weights and batch:
    loss, every gradient and every updated parameter must agree."""
    cfg = train_config(layers=2)
    batch = train_batch(cfg, B, S, seed=1)
    runs = []
    for kernels in (False, True):
        step, trees, _ = make_train_step(cfg, torch.float32, kernels, seed=2)
        loss, grads = step(batch)
        runs.append((float(loss), [g.detach() for g in grads],
                     [v.detach() for t in trees for v in t.values()]))
        del step, trees
    (l0, g0, p0), (l1, g1, p1) = runs
    print(f"  2-layer f32 step at full width, B={B} S={S}: loss plain "
          f"{l0:.7f}, kernels {l1:.7f}")
    require(abs(l1 - l0) <= 1e-5 * abs(l0), "loss differs (rtol 1e-5)")
    # gradients: max abs difference within 1e-4 of the tensor's max |grad|
    # (f32 sums in other orders through two layers)
    g_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(g1, g0))
    # updated parameters: a first AdamW step moves a weight by about +-lr,
    # so a near-zero gradient whose sign differs moves it by up to 2 lr
    p_err = max((a - b).abs().max().item() for a, b in zip(p1, p0))
    p_mean = max((a - b).abs().mean().item() for a, b in zip(p1, p0))
    print(f"  grads: max |kernel - plain| / max |plain| {g_err:.3e} (tol "
          f"1e-4); updated params: max abs diff {p_err:.3e} (tol 2.1e-4 = "
          f"2 lr + decay), largest mean abs diff {p_mean:.3e} (tol 1e-6)")
    require(g_err <= 1e-4, "gradients differ")
    require(p_err <= 2.1e-4 and p_mean <= 1e-6, "updated parameters differ")


class PlainAttention:
    """Within the block, rows 3/5/6's wrappers run their plain versions on
    the card (the same function, the same dropout mask from the same seed):
    phase 4c's reference for the dropout kernels inside a train step."""

    NAMES = ("flash_attention_fwd", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")

    def __enter__(self):
        from paddle_tpu_torch.ops import flash_attention as fa
        self.fa = fa
        self.saved = {n: getattr(fa, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(fa, n, getattr(fa, n + "_ref"))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.fa, n, fn)


def ernie_step_once(cfg, ids, kernels, plain_attention=False):
    """One f32 step (loss, gradients, updated parameters) of the model
    seeded with 2, so two calls draw the same weights and the same dropout
    masks."""
    step, params, _ = make_ernie_step(cfg, torch.float32, kernels, seed=2)
    if plain_attention:
        with PlainAttention():
            loss, grads = step((ids, ids))
    else:
        loss, grads = step((ids, ids))
    return (float(loss), [g.detach() for g in grads],
            [v.detach() for v in params.values()])


def hold_step_pair(what, plain, kern):
    """Phase 4c's and 4d's gates on two train steps (the ERNIE or ViT
    model): loss, every gradient and every updated parameter."""
    (l0, g0, p0), (l1, g1, p1) = plain, kern
    print(f"  {what}: loss plain {l0:.7f}, kernels {l1:.7f}")
    require(abs(l1 - l0) <= 1e-5 * abs(l0), "loss differs (rtol 1e-5)")
    # gradients: max abs difference within 1e-4 of the tensor's max |grad|.
    # The k biases' gradient is zero in exact arithmetic (it shifts a whole
    # row of scores: what is left is rounding noise) and the pooler's is
    # zeros, so each tensor's max |grad| is floored at 1e-3 of the step's
    # largest
    g_max = max(b.abs().max().item() for b in g0)
    noise = [b.abs().max().item() < 1e-3 * g_max for b in g0]
    g_err = max(((a - b).abs().max().item()
                 / max(b.abs().max().item(), 1e-3 * g_max))
                for a, b in zip(g1, g0))
    # updated parameters: the fused update rounds the same function once
    # differently, and a first AdamW step moves a weight by about +-lr, so
    # a near-zero gradient whose sign differs moves it by up to 2 lr; the
    # mean gate leaves out the tensors whose gradient is rounding noise,
    # whose first step is +-lr by the noise's sign on either side
    p_err = max((a - b).abs().max().item() for a, b in zip(p1, p0))
    p_mean = max((a - b).abs().mean().item()
                 for a, b, z in zip(p1, p0, noise) if not z)
    print(f"  grads: max |kernel - plain| / max |plain| {g_err:.3e} (tol "
          f"1e-4); updated params: max abs diff {p_err:.3e} (tol 2.1e-4 = "
          f"2 lr + decay), largest mean abs diff {p_mean:.3e} (tol 1e-6; "
          f"{sum(noise)} tensors with a gradient of rounding noise left "
          f"out)")
    require(g_err <= 1e-4, "gradients differ")
    require(p_err <= 2.1e-4 and p_mean <= 1e-6, "updated parameters differ")


def phase_ernie_check(B=16, S=512):
    """Phase 4c: f32 ERNIE steps at full width and 2 layers from the same
    seeded weights and batch.  At dropout 0, the kernels (flash attention,
    LayerNorm, fused AdamW) against all three knobs off; at the published
    dropout 0.1, the kernels against the same step with rows 3/5/6 replaced
    by their plain versions (the same seeds and the same generator states
    for every mask).  Loss, every gradient and every updated parameter
    must agree."""
    cfg = ernie_config(layers=2, dropout=0.0)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    hold_step_pair(f"2-layer f32 ERNIE step at full width, B={B} S={S}, "
                    f"dropout 0, all knobs off against on",
                    ernie_step_once(cfg, ids, False),
                    ernie_step_once(cfg, ids, True))
    torch.cuda.empty_cache()
    cfg = ernie_config(layers=2)
    hold_step_pair(f"2-layer f32 ERNIE step, B={B} S={S}, dropout "
                    f"{DROPOUT_RATE}, rows 3/5/6 plain against kernels",
                    ernie_step_once(cfg, ids, True, plain_attention=True),
                    ernie_step_once(cfg, ids, True))


# -- phase 3g: ViT-L/16 training ---------------------------------------------
# ViT's step has ERNIE's groups; at 224 px no flash-attention kernel runs
# (the JAX dispatch's plain path)
VIT224_GROUPS = ERNIE_GROUPS[2:]
VIT_L = dict(embed_dim=1024, num_heads=16, mlp_ratio=4.0, patch_size=16)


def vit_flop(B, img, layers=24, E=1024, classes=1000):
    """Model FLOP of one ViT-L/16 train step (forward and backward, no
    recomputation): 6 per multiply-add-carrying weight and token for the
    blocks' four products (12 E^2 weights each), the patch projection
    (3 x 16 x 16 x E, once per patch) and the head (once per image), and
    12 S^2 E per layer and image for the two attention products (4 S^2 E
    forward, twice that backward)."""
    s = (img // 16) ** 2 + 1
    mm = layers * 12 * E * E * s + 3 * 16 * 16 * E * (s - 1) + E * classes
    return 6.0 * B * mm + 12.0 * B * layers * s * s * E


def make_vit_step(img, dtype, kernels, seed=0, layers=24):
    """bench.py bench_vit_l16's step on the port: ViT-L/16 at ``img`` px
    (``vit_l_16``; the class at ViT-L's widths with ``layers`` blocks when
    cut), 1,000 classes, cross-entropy through ``log_softmax`` in f32, and
    one AdamW(lr 1e-4, weight decay 0.01: the JAX default) update of every
    parameter.  With ``kernels`` all three knobs are on (flash attention,
    the LayerNorm kernels, the fused AdamW kernel); without, all three are
    off.  Returns (step(batch) -> (loss, grads), params, n_params)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.vision.models import VisionTransformer, vit_l_16

    kw = dict(img_size=img, num_classes=1000, dtype=dtype, device="cuda",
              seed=seed, kernels=kernels, norm_kernels=kernels)
    model = vit_l_16(**kw) if layers == 24 else VisionTransformer(
        **VIT_L, depth=layers, **kw)
    params = dict(model.named_parameters())
    opt = AdamW(learning_rate=1e-4, fused=kernels)
    state = opt.init_opt_state(params, device="cuda")

    def step(batch, marks=None):
        mark = (lambda i: marks[i].record()) if marks else (lambda i: None)
        x, y = batch
        mark(0)
        logp = torch.log_softmax(model(x).float(), dim=-1)
        loss = -logp.gather(1, y[:, None]).mean()
        mark(1)
        grads = torch.autograd.grad(loss, list(params.values()))
        mark(2)
        opt.apply_gradients_functional(params, dict(zip(params, grads)),
                                       state)
        mark(3)
        return loss.detach(), grads

    return step, params, sum(v.numel() for v in params.values())


def vit_batch(B, img, dtype, seed=0):
    """bench_vit_l16's batch: N(0, 1) images and random labels of 1,000
    classes from ``seed``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (B, 3, img, img)).astype(
        np.float32)).cuda().to(dtype)
    y = torch.from_numpy(rng.integers(0, 1000, (B,))).cuda()
    return x, y


def phase_vit(pa, img=384, B=32, warmup=3, steps=10):
    """ViT-L/16 training in bf16 (f32 moments) at ``img`` px, batch B,
    full width and depth, all three knobs on: warm-up and timed steps on
    one fixed batch with the loss of each (finite and falling), images/s,
    the mfu share (``vit_flop`` over 989 TFLOP/s), peak memory, launches
    per step (asserted: at 577 tokens the segment branch of rows 3/5/6
    once per layer through the op's pad path; at 197 no flash-attention
    kernel, the plain path once per layer as the JAX dispatch sends it;
    rows 12/13 per norm, row 9 per parameter tensor; no other plain
    version), the stage split and one step under torch.profiler."""
    L = 24
    S = (img // 16) ** 2 + 1
    torch.cuda.reset_peak_memory_stats()
    step, params, n_params = make_vit_step(img, torch.bfloat16, True)
    batch = vit_batch(B, img, torch.bfloat16)
    losses = []
    for _ in range(warmup):
        losses.append(float(step(batch)[0]))
    torch.cuda.synchronize()
    reset_counts(pa)
    with CountPlainCalls() as plain:
        t0 = time.perf_counter()
        out = [step(batch)[0] for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in train_wrappers().items()}
    launches.update(branch_counts())
    per_step = {k: n / steps for k, n in launches.items()}
    losses += [float(x) for x in out]
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    flash = L if S >= 384 else 0
    want = dict({k: 0 for k in per_step}, fa_fwd=flash, fa_dkv=flash,
                fa_dq=flash, fa_fwd_seg=flash, fa_dkv_seg=flash,
                fa_dq_seg=flash, adamw=len(params), ln_fwd=2 * L + 1,
                ln_bwd=2 * L + 1)
    require(per_step == want, f"launches per step {per_step} != {want}")
    require(counts(pa) == (0, 0, 0), f"paged attention ran: {counts(pa)}")
    plain_want = {} if flash else {"flash_attention_ref": L * steps}
    require(plain.calls == plain_want,
            f"plain calls {plain.calls} != {plain_want}")
    if flash:
        from paddle_tpu_torch.ops import flash_attention as fa
        require_bodies(fa, "the segment launches",
                       VIT_L["embed_dim"] // VIT_L["num_heads"], True, False)
    images_per_s = B * steps / wall
    flop = vit_flop(B, img)
    mfu = flop * steps / wall / BF16_FLOP_PER_S
    peak = torch.cuda.max_memory_allocated()
    print(f"  {n_params:,} parameters in {len(params)} tensors, {S} tokens "
          f"({S - 1} patches + the class token"
          + (f", padded to {-(-S // 128) * 128} in attention" if flash
             else ", attention on the plain path") + f"), B={B} bf16 (f32 "
          f"moments), 1,000 classes, AdamW(lr=1e-4, wd=0.01) fused")
    print(f"  loss per step ({warmup} warm-up + {steps} timed): "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"  {steps} steps in {wall:.3f} s: {wall / steps * 1e3:.1f} ms per "
          f"step, {images_per_s:.1f} images/s, mfu_share {mfu:.4f} "
          f"({flop / 1e12:.2f} TFLOP per step / 989 TFLOP/s)")
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    print(f"  launches per step: {json.dumps(per_step)}; plain calls "
          f"{json.dumps(plain.calls)}")
    breakdown = train_breakdown(step, batch, wall / steps,
                                ERNIE_GROUPS if flash else VIT224_GROUPS)
    return dict(launches=launches, images_per_s=images_per_s, mfu=mfu,
                step_ms=wall / steps * 1e3, peak_gib=peak / 2**30,
                losses=losses, n_params=n_params, breakdown=breakdown)


def phase_vit_check(B=8, img=384):
    """Phase 4d: one f32 ViT-L/16 step at ``img`` px, full width, 2 layers,
    with all three knobs on (the segment branch of rows 3/5/6 through the
    pad path, the LayerNorm kernels, the fused AdamW) and one with all off,
    from the same seeded weights and batch: loss, every gradient and every
    updated parameter must agree.  Each qkv bias enters the gates as its
    q, k and v thirds, the tensors ERNIE keeps apart: the k bias's gradient
    is rounding noise (it shifts a whole row of scores), which the gates
    treat tensor by tensor."""
    batch = vit_batch(B, img, torch.float32, seed=1)

    def split(names, tensors):
        return [part for n, t in zip(names, tensors) for part in
                (t.detach().chunk(3) if n.endswith("attn.qkv.bias")
                 else (t.detach(),))]

    runs = []
    for kernels in (False, True):
        step, params, _ = make_vit_step(img, torch.float32, kernels, seed=2,
                                        layers=2)
        loss, grads = step(batch)
        runs.append((float(loss), split(params, grads),
                     split(params, params.values())))
        del step, params
    hold_step_pair(f"2-layer f32 ViT-L/16 step at {img} px, full width, "
                   f"B={B}, all knobs off against on", *runs)
    torch.cuda.empty_cache()


# -- phase 4: kernel engine == plain engine ----------------------------------
def engine_tokens(params, cfg, prompts, **kw):
    from paddle_tpu_torch.inference.paged import ServingEngine
    eng = ServingEngine(params, cfg, num_slots=3, page_size=16,
                        num_pages=160, max_pages_per_seq=32,
                        prompt_bucket=32, decode_horizon=8,
                        prefill_chunk=128, device="cuda", **kw)
    rids = [eng.submit(p, max_new_tokens=24) for p in prompts]
    done = eng.run()
    eng.check_invariants()
    return [list(done[i].generated) for i in rids], eng.stats()


def phase_engine(pa, cfg7b):
    from paddle_tpu_torch.models.llama import init_llama_params

    cfg = dataclasses.replace(cfg7b, num_hidden_layers=2)
    ep, bp, hp = init_llama_params(cfg, dtype=torch.float32, device="cuda",
                                   seed=1)
    bp = {k: (v * 0.15 if k.startswith("w") else v) for k, v in bp.items()}
    hp = dict(hp, lm=(ep["tok"].T * 4.0).contiguous())
    r = np.random.default_rng(2)
    prefix = r.integers(1, cfg.vocab_size, 160)
    prompts = [r.integers(1, cfg.vocab_size, n) for n in (20, 300, 75)]
    prompts += [np.concatenate([prefix, r.integers(1, cfg.vocab_size, n)])
                for n in (10, 40)]
    prompts.insert(1, prefix)
    for kv_dtype in (None, "int8", "fp8"):
        reset_counts(pa)
        kern, st = engine_tokens((ep, bp, hp), cfg, prompts,
                                 kv_dtype=kv_dtype)
        used = counts(pa)
        plain, _ = engine_tokens((ep, bp, hp), cfg, prompts,
                                 kv_dtype=kv_dtype, attention_impl="ref")
        over, st_o = engine_tokens((ep, bp, hp), cfg, prompts,
                                   kv_dtype=kv_dtype, overlap=True)
        require(used[0 if kv_dtype is None else 1] > 0 and used[2] == 0,
                f"engine check [{kv_dtype}]: kernel launches / plain calls "
                f"{used}")
        require(st["cache_hits"] >= 1,
                "engine check: the shared prefix hit the cache")
        print(f"  2-layer f32 engine at 7B widths, {kv_dtype or 'f32'} "
              f"pages: {len(prompts)} requests x 24 greedy tokens, kernel "
              f"== plain: {kern == plain}, overlap=True == kernel: "
              f"{over == kern} ({st_o['overlap_steps']} overlapped steps)")
        require(kern == plain, f"greedy tokens differ between kernel and "
                f"plain version [{kv_dtype}]")
        require(over == kern and st_o["overlap_steps"] > 0,
                f"overlap=True changed greedy tokens [{kv_dtype}]")
    # speculative=4 against no speculation, both through the quantized
    # kernel, on the successor model with prompts holding its path
    ep, bp, hp = init_llama_params(cfg, dtype=torch.float32, device="cuda",
                                   seed=3)
    succ = successor_model((ep, bp, hp), seed=4)
    prompts = []
    for n, stretch in ((40, 12), (300, 30), (75, 20), (20, 6)):
        x = int(r.integers(1, cfg.vocab_size))
        prompts.append(np.concatenate([
            r.integers(1, cfg.vocab_size, n - stretch - 5),
            path(succ, x, stretch), r.integers(1, cfg.vocab_size, 4), [x]]))
    spec, st = engine_tokens((ep, bp, hp), cfg, prompts, kv_dtype="int8",
                             speculative=4)
    nospec, _ = engine_tokens((ep, bp, hp), cfg, prompts, kv_dtype="int8")
    spec_over, _ = engine_tokens((ep, bp, hp), cfg, prompts, kv_dtype="int8",
                                 speculative=4, overlap=True)
    print(f"  speculative=4 vs none, int8 pages, through the kernel: "
          f"{st['verify_steps']} verify steps, drafts {st['draft_tokens_accepted']}"
          f"/{st['draft_tokens_proposed']} accepted, same tokens: "
          f"{spec == nospec}, with overlap=True: {spec_over == spec}")
    require(st["verify_steps"] > 0, "engine check: no verify step ran")
    require(spec == nospec, "speculative decoding changed greedy tokens")
    require(spec_over == spec, "overlap=True changed speculative tokens")
    require(all(t == path(succ, succ[p[-1]], 24)
                for p, t in zip(prompts, spec)),
            "engine check: tokens leave the successor model's path")


# -- phase 5: timing ---------------------------------------------------------
def time_ms(fn, iters, warmup=3):
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters, side=None):
    """Device ms per call of fn: ``iters`` calls captured in one CUDA graph
    and replayed, so the wrapper's host cost (tens of us per eager call)
    does not hide a kernel that is faster than it.  The warm-up calls and
    the capture run on the stream ``side`` (a new one by default): an
    autograd backward is captured when its forward ran on that stream."""
    side = side or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i)
    return time_ms(lambda i: graph.replay(), 5, warmup=1) / iters


def bound(q_len, q_start, kv_len, Hq, Hkv, D, ps, elt, flop_rate,
          kv_dtype=None):
    """Least time for the work these inputs need: each input byte read once
    (q rows, the K/V rows the segments can see — with one f32 scale per row
    on quantized pages — their page-table entries, the descriptors), each
    output byte written once; QK^T and PV at 2 operations per multiply-add
    over the visible (query, key) pairs."""
    rows_visible = sum(
        min(kl, qs + j + 1) for qs, ql, kl in zip(q_start, q_len, kv_len)
        for j in range(ql))
    kv_tokens = sum(min(kl, qs + ql) if ql else 0
                    for qs, ql, kl in zip(q_start, q_len, kv_len))
    n_q = sum(q_len)
    row_bytes = D * elt if kv_dtype is None else D + 4
    nbytes = (2 * n_q * Hq * D * elt                  # q read, out written
              + 2 * kv_tokens * Hkv * row_bytes       # K and V read
              + 4 * sum(-(-kl // ps) for kl in kv_len)  # page-table rows
              + 3 * 4 * len(kv_len))
    flops = 4 * D * Hq * rows_visible
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def shape_inputs(gen, sh, kv_dtype, n_copies=4, D=128):
    """bf16 q (32 heads of D, page 16) at one segment shape, and
    ``n_copies`` page pools (> the 50 MB L2 together) of bf16 pages or of
    int8 / fp8 codes with their scales; the slots' pages in a random order."""
    from paddle_tpu_torch.serving.quant import kv_spec, quantize_kv
    dt, Hq, Hkv, ps = torch.bfloat16, 32, 32, 16
    S, Qmax = sh["S"], sh["Qmax"]
    P = max(-(-k // ps) for k in sh["kv_len"])
    NP = S * P
    q = torch.randn(S, Qmax, Hq, D, generator=gen, device="cuda").to(dt)
    pools = []
    for _ in range(n_copies):
        kv = [torch.randn(Hkv, NP, ps, D, generator=gen, device="cuda")
              for _ in range(2)]
        if kv_dtype is None:
            pools.append(([t.to(dt) for t in kv], {}))
        else:
            sd, qmax = kv_spec(kv_dtype)
            (kq, ks), (vq, vs) = (quantize_kv(t, qmax=qmax, dtype=sd)
                                  for t in kv)
            pools.append(([kq, vq], dict(k_scales=ks, v_scales=vs)))
    pt = torch.randperm(NP, generator=gen, device="cuda") \
        .to(torch.int32).reshape(S, P)
    seg = [torch.tensor(sh[k], dtype=torch.int32, device="cuda")
           for k in ("q_start", "q_len", "kv_len")]
    return q, pools, pt, seg


def time_shape(pa, gen, sh, kv_dtype, D=128):
    """Kernel ms at one segment shape (32 heads of D) as a CUDA-graph
    replay (the device's time: the wrapper's host cost, tens of us per
    call, would hide it), its eager ms on a line of its own, the plain
    version's ms (eager), and the bound.  The kernel's time includes the
    split merge where the plan splits."""
    q, pools, pt, seg = shape_inputs(gen, sh, kv_dtype, D=D)
    Hq, Hkv, ps = 32, 32, 16
    n_copies = len(pools)

    def kern(i):
        (k, v), sc = pools[i % n_copies]
        pa.ragged_paged_attention(q, k, v, pt, *seg, **sc)

    def plain(i):
        (k, v), sc = pools[i % n_copies]
        pa.ragged_paged_attention_ref(q, k, v, pt, *seg, **sc)

    ms = graph_ms(kern, 200)
    eager_ms = time_ms(kern, 200)
    plain_ms = time_ms(plain, 20)
    b_ms, b_by, nbytes, flops = bound(sh["q_len"], sh["q_start"],
                                      sh["kv_len"], Hq, Hkv, D, ps, 2,
                                      BF16_FLOP_PER_S, kv_dtype)
    plan = pa.split_plan(sh["S"], sh["Qmax"], Hq, Hkv, D, pt.shape[1], ps,
                         True, sms=torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    tag = f"{kv_dtype or 'bf16':<5} {sh['name']:<6}" + \
        ("" if D == 128 else f" D={D}")
    print(f"  {tag} S={sh['S']} Qmax={sh['Qmax']} kv_len={sh['kv_len']}: "
          f"kernel {ms:.4f} ms (graph replay; {plan.n_splits} splits of "
          f"{plan.split_len} tokens, {plan.blocks} blocks), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), "
          f"{b_ms / ms * 100:.1f}% of bound; library_ms null")
    print(f"  {tag} eager (one wrapper call each, host cost included): "
          f"{eager_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                eager_ms=eager_ms)


def shapes(kv_lens):
    """The decode, verify (q_len = 5) and chunk segments of a phase-3 run
    whose first four requests sit at kv_lens."""
    return [dict(name="decode", S=4, Qmax=1, q_start=[k - 1 for k in kv_lens],
                 q_len=[1] * 4, kv_len=list(kv_lens)),
            dict(name="verify", S=4, Qmax=5, q_start=[k - 5 for k in kv_lens],
                 q_len=[5] * 4, kv_len=list(kv_lens)),
            dict(name="chunk", S=1, Qmax=256, q_start=[256], q_len=[256],
                 kv_len=[512])]


def timing_shapes(plain_kv, quant_kv):
    """(pages, shape) of every timed rows-1/2 shape: row 1 at phase 3a's
    decode and chunk shapes and at the verify shape of phase 3b's lengths,
    row 2 over int8 pages at phase 3b's decode, verify and chunk shapes, and
    over fp8 pages at its decode shape."""
    plain, quant = shapes(plain_kv), shapes(quant_kv)
    return ([(None, sh) for sh in (plain[0], quant[1], plain[2])]
            + [("int8", sh) for sh in quant] + [("fp8", quant[0])])


def phase_timing(pa, layers, plain_kv, quant_kv, parent=None):
    """Rows 1-2 at the phase-3 shapes (:func:`timing_shapes`), the split
    merge alone at phase 3a's decode shape, one line per design step (the
    split count, the ring depth, the warps of a CUDA-core block), and with
    ``parent`` (another commit's ``csrc``) that build's kernels timed in
    turns with these."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    res = {"plain": {}, "quant": {}}
    for kv_dtype, sh in timing_shapes(plain_kv, quant_kv):
        r = time_shape(pa, gen, sh, kv_dtype)
        if kv_dtype != "fp8":
            res["plain" if kv_dtype is None else "quant"][sh["name"]] = r
    res["combine"] = combine_timing(pa, gen, plain_kv)
    print(f"  launches: {layers} per decode step, per verify step and per "
          f"prefill chunk (one per layer), of row 1 on an f32/bf16 store "
          f"and of row 2 on an int8/fp8 store, each followed by the merge "
          f"when its plan splits")
    print("  library_ms is null: no single PyTorch call attends over a paged,"
          " ragged KV cache (SDPA needs the pages gathered dense first)")
    print("  design steps of rows 1-2 (each variant held against the plain "
          "version first):")
    ragged_design_steps(pa, gen, timing_shapes(plain_kv, quant_kv)[:5])
    if parent is not None:
        print(f"  rows 1, 2 and 10 against the build of {parent}, in turns:")
        parent_serving_turns(parent, pa, gen,
                             timing_shapes(plain_kv, quant_kv))
    return res


def combine_timing(pa, gen, kv_lens):
    """The split merge alone on the partials phase 3a's decode shape leaves
    (splits past a slot's tokens empty): held against its plain version,
    then its graph-replay ms, plain ms and bound (the partials it reads —
    m and l of every split, the accumulators of the live ones — and the
    bf16 rows it writes)."""
    Hq, D, ps = 32, 128, 16
    P = max(-(-k // ps) for k in kv_lens)
    plan = pa.split_plan(len(kv_lens), 1, Hq, Hq, D, P, ps, True,
                         sms=torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    live = torch.tensor([[sp * plan.split_len < k for k in kv_lens]
                         for sp in range(plan.n_splits)], device="cuda")
    ml, acc = random_partials(gen, plan.n_splits, len(kv_lens), Hq, 1, D,
                              live)
    q_len = torch.ones(len(kv_lens), dtype=torch.int32, device="cuda")
    args = (ml, acc, q_len, Hq, torch.bfloat16)
    held(f"combine at the decode shape ({plan.n_splits} splits)",
         pa.ragged_paged_attention_combine(*args),
         pa.ragged_paged_attention_combine_ref(*args),
         TRAIN_TOL[torch.bfloat16])
    n_live = int(live.sum()) * Hq
    nbytes = ml.numel() * 4 + n_live * D * 4 + len(kv_lens) * Hq * D * 2 \
        + 4 * len(kv_lens)
    return report(f"combine ({plan.n_splits} splits)",
                  graph_ms(lambda i: pa.ragged_paged_attention_combine(*args),
                           200),
                  time_ms(lambda i: pa.ragged_paged_attention_combine_ref(
                      *args), 20),
                  None, nbytes, 2 * n_live * D, "none", F32_FLOP_PER_S)


# Design steps of rows 1-2: compile-time settings of
# ragged_paged_attention.cuh, each built into libraries of their own and
# timed against the shipped build (the first entry) in one run; then the
# split count (the blocks per SM the plan aims at) on the shipped build.
RPA_VARIANTS = (
    ("shipped: 4 warps per CUDA-core block, rings of 2", ()),
    ("ring depth 3", ("-DRPA_STAGES=3",)),
    ("2 warps per CUDA-core block", ("-DRPA_WARPS=2",)),
    ("8 warps per CUDA-core block", ("-DRPA_WARPS=8",)),
)
# (blocks per SM the plan aims at for CUDA-core tiles, for tensor-core
# tiles (0: one split), the fewest rows that take the tensor-core tile)
SPLIT_STEPS = ((2, 2, 2), (8, 2, 2), (4, 1, 2), (4, 4, 2), (4, 2, 16))
RPA_LIBS = ("ragged_paged_attention", "ragged_paged_attention_quant")


def ragged_ptxas(paths):
    """The most registers and spill stores over the instantiations of each
    ragged kernel in the ptxas reports of ``paths`` (every head width)."""
    most = {}
    for lib in rpa_libs(paths):
        for kern, _, regs, stores, _ in ptxas_lines(paths[lib]):
            key = kern[len("ragged_paged_attention_"):] + (
                " (quant)" if "quant" in lib else "")
            r, st = most.get(key, (0, 0))
            most[key] = (max(r, regs), max(st, stores))
    return ", ".join(f"{k} {r} registers, {st} B spilled"
                     for k, (r, st) in most.items())


def ragged_design_steps(pa, gen, timed):
    """One line per entry of ``RPA_VARIANTS`` and of ``SPLIT_STEPS``: each
    variant's output at every ``timed`` (pages, shape) held against the
    plain version, then its graph-replay ms there.  A measurement only: the
    port loads the shipped build and plan, which are put back however this
    ends."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(RPA_VARIANTS)) as pool:
        paths = list(pool.map(
            lambda var: _build.build_all(list(RPA_LIBS), var[1]),
            RPA_VARIANTS))
    print(f"  built {len(paths)} variants in {time.perf_counter() - t0:.1f} s")
    cases = []
    for kv_dtype, sh in timed:
        q, pools, pt, seg = shape_inputs(gen, sh, kv_dtype)
        (k, v), sc = pools[0]
        want = pa.ragged_paged_attention_ref(q, k, v, pt, *seg, **sc)
        cases.append((f"{kv_dtype or 'bf16'} {sh['name']}", q, pools, pt,
                      seg, want))
    shipped = {n: _build.library(n) for n in RPA_LIBS}
    blocks = (pa.BLOCKS_PER_SM, pa.MMA_BLOCKS_PER_SM, pa.MMA_MIN_ROWS)
    runs = [(what, path, blocks) for (what, _), path in zip(RPA_VARIANTS,
                                                           paths)]
    runs += [(f"split plan for {b} (CUDA-core) / {m} (tensor-core) blocks "
              f"per SM, tensor cores from {r} rows", paths[0], (b, m, r))
             for b, m, r in SPLIT_STEPS]
    runs.append((RPA_VARIANTS[0][0], paths[0], blocks))
    try:
        for what, path, b in runs:
            for n in RPA_LIBS:
                _build._LIBS[n] = ctypes.CDLL(str(path[n]))
            pa.BLOCKS_PER_SM, pa.MMA_BLOCKS_PER_SM, pa.MMA_MIN_ROWS = b
            line = []
            for name, q, pools, pt, seg, want in cases:
                (k, v), sc = pools[0]
                hold_ragged(f"{name} [{what}]", pa.ragged_paged_attention(
                    q, k, v, pt, *seg, **sc), want, bool(sc))
                ms = graph_ms(lambda i: pa.ragged_paged_attention(
                    q, *pools[i % len(pools)][0], pt, *seg,
                    **pools[i % len(pools)][1]), 200)
                line.append(f"{name} {ms:.4f}")
            print(f"  design step {what}: {', '.join(line)} ms ("
                  f"{ragged_ptxas(path)})")
    finally:
        _build._LIBS.update(shipped)
        pa.BLOCKS_PER_SM, pa.MMA_BLOCKS_PER_SM, pa.MMA_MIN_ROWS = blocks
    del cases
    torch.cuda.empty_cache()


def hold_ragged(name, got, want, quant):
    """A ragged kernel's bf16 output against the plain version's, at
    phase 2's tolerance for it."""
    torch.cuda.synchronize()
    atol, rtol = TOL_QUANT_BF16 if quant else TOL[torch.bfloat16]
    err = (got.float() - want.float()).abs()
    require(bool((err <= atol + rtol * want.float().abs()).all()),
            f"{name}: kernel vs plain max abs err {err.max().item():.3e}")


def parent_serving_turns(parent, pa, gen, timed):
    """``--parent DIR``: the ragged entries and ``softmax.cu`` of another
    commit (DIR holds its ``csrc``), built with the same flags and timed in
    turns with the shipped build — parent, new, new, parent — on the same
    inputs: rows 1-2 at every ``timed`` shape through the wrapper, and row
    10 at ``SOFTMAX_SHAPE`` bf16 (CUDA-graph replays).
    Every output is held against the plain version first."""
    import ctypes
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused as fu
    names = [*RPA_LIBS, "softmax"]
    old = {n: ctypes.CDLL(str(p)) for n, p in
           _build.build_all(names, csrc=Path(parent)).items()}
    cases = []
    for kv_dtype, sh in timed:
        q, pools, pt, seg = shape_inputs(gen, sh, kv_dtype)
        (k, v), sc = pools[0]
        want = pa.ragged_paged_attention_ref(q, k, v, pt, *seg, **sc)
        cases.append((f"{kv_dtype or 'bf16'} {sh['name']}", q, pools, pt,
                      seg, want))
    rows, hs = int(np.prod(SOFTMAX_SHAPE[:-1])), SOFTMAX_SHAPE[-1]
    xs = (2 * torch.randn(rows, hs, generator=gen, device="cuda")).bfloat16()
    want_s = fu.softmax_fwd_ref(xs)
    shipped = {n: _build.library(n) for n in names}
    try:
        for side in ("parent", "new", "new", "parent"):
            _build._LIBS.update(old if side == "parent" else shipped)
            line = []
            for name, q, pools, pt, seg, want in cases:
                def run(i):
                    (k, v), sc = pools[i % len(pools)]
                    return pa.ragged_paged_attention(q, k, v, pt, *seg, **sc)
                hold_ragged(f"{name} [{side}]", run(0), want,
                            bool(pools[0][1]))
                line.append(f"{name} {graph_ms(run, 200):.4f}")
            held(f"softmax o [{side}]", fu.softmax_fwd(xs), want_s,
                 TRAIN_TOL[torch.bfloat16])
            line.append(f"softmax fwd {graph_ms(lambda i: fu.softmax_fwd(xs), 100):.4f}")
            print(f"  turn {side}: {', '.join(line)} ms")
    finally:
        _build._LIBS.update(shipped)
    del cases, xs, want_s
    torch.cuda.empty_cache()


def causal_pairs(s_q, s_k):
    """Visible (query, key) pairs of one causal head, bottom-right aligned."""
    off = s_k - s_q
    return sum(min(s_k, i + off + 1) for i in range(s_q))


def report(name, ms, plain_ms, library_ms, nbytes, flops, library_what,
           flop_rate=BF16_FLOP_PER_S, int_ops=0):
    """One kernel's time beside its bound: the larger of its bytes over
    3.35 TB/s, its floating-point operations over ``flop_rate`` and its
    integer operations (the dropout mask's) over ``INT32_OP_PER_S``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / flop_rate, int_ops / INT32_OP_PER_S)
    b_ms = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    lib = "null" if library_ms is None else f"{library_ms:.4f} ms"
    ints = f", {int_ops / 1e9:.2f} G int32 ops" if int_ops else ""
    print(f"  {name:<24} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} "
          f"GFLOP{ints}), {b_ms / ms * 100:.2f}% of bound; library {lib} "
          f"({library_what})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=library_ms)


def attention_timing(fa, gen, shape, causal, label="", rate=0.0):
    """Rows 3, 5 and 6 at one bf16 shape, at dropout ``rate``: the kernel,
    its plain version, the bound (with the mask's Philox work under
    dropout) and the library calls (timed here only; the port never calls
    them): SDPA's forward for row 3 (with ``dropout_p=rate``), and for rows
    5 and 6 SDPA's backward alone (``autograd.grad`` on a retained forward
    graph), with its forward + backward printed beside it."""
    b, s_q, s_k, hq, hkv, d = shape
    q, k, v, do = attn_inputs(gen, shape, torch.bfloat16)
    sc = 1.0 / np.sqrt(d)
    args = (causal, sc, rate, 1234)
    o, lse = fa.flash_attention_fwd(q, k, v, *args)
    delta = delta_of(do, o)
    pairs = b * hq * (causal_pairs(s_q, s_k) if causal else s_q * s_k)
    q_bytes, kv_bytes = b * s_q * hq * d * 2, b * s_k * hkv * d * 2
    stats_bytes = b * hq * s_q * 4
    # the mask needs one 32-bit word per visible score: a Philox call per 4
    mask_ops = PHILOX_OPS * pairs / 4 if rate > 0 else 0
    lib_fwd, lib_bwd, lib_both = sdpa_times(q, k, v, do, dropout_p=rate,
                                            is_causal=causal)
    mode = "causal" if causal else "non-causal"
    mode += f", dropout_p={rate:g}" if rate > 0 else ""
    bwd_what = (f"SDPA {mode} backward alone; forward + backward "
                f"{lib_both:.4f} ms")
    res = {}
    res["fa_fwd"] = report(
        f"flash_attention_fwd{label}",
        time_ms(lambda i: fa.flash_attention_fwd(q, k, v, *args), 10),
        time_ms(lambda i: fa.flash_attention_fwd_ref(q, k, v, *args), 3,
                warmup=1), lib_fwd,
        2 * q_bytes + 2 * kv_bytes + stats_bytes, 4 * d * pairs,
        f"SDPA {mode} forward", int_ops=mask_ops)
    res["fa_dkv"] = report(
        f"flash_attention_bwd_dkv{label}",
        time_ms(lambda i: fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                     delta, *args), 5),
        time_ms(lambda i: fa.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse, delta, *args), 3, warmup=1), lib_bwd,
        2 * q_bytes + 4 * kv_bytes + 2 * stats_bytes, 8 * d * pairs,
        bwd_what, int_ops=mask_ops)
    res["fa_dq"] = report(
        f"flash_attention_bwd_dq{label}",
        time_ms(lambda i: fa.flash_attention_bwd_dq(q, k, v, do, lse,
                                                    delta, *args), 5),
        time_ms(lambda i: fa.flash_attention_bwd_dq_ref(
            q, k, v, do, lse, delta, *args), 3, warmup=1), lib_bwd,
        3 * q_bytes + 2 * kv_bytes + 2 * stats_bytes, 6 * d * pairs,
        bwd_what, int_ops=mask_ops)
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return res


def sdpa_times(q, k, v, do, **sdpa):
    """SDPA (the library call for the same function; timed here only, the
    port never calls it) on [B, S, H, D] q, k, v with the keyword
    arguments ``sdpa`` (``dropout_p``, ``is_causal``, ``attn_mask``): the
    forward, the backward alone (``autograd.grad`` on a retained forward
    graph) and forward + backward, in ms."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # SDPA's layout
    fwd = time_ms(lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, **sdpa), 20)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    dot = do.transpose(1, 2)
    out = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
    bwd = time_ms(lambda i: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True), 10)
    both = time_ms(lambda i: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, **sdpa), (qg, kg, vg),
        dot), 10)
    return fwd, bwd, both


def segment_inputs(fa, gen, shape, lens):
    """bf16 inputs of the segment branch at ``shape`` (B, S, S, H, H, D):
    ``lens`` "pad" pads the S rows to the tile by the op's ``_pad_to_tile``
    (dO's padding rows zero, as the op's backward gets them), else segment
    lengths (``segment_ids``).  Returns the unpadded (q, k, v, do), the
    kernels' (q, k, v, do, ids), SDPA's boolean mask for the same function
    (None for "pad": SDPA takes the unpadded inputs) and the (query, key)
    pairs that the function needs."""
    b, s, _, h, _, d = shape
    q, k, v, do = attn_inputs(gen, shape, torch.bfloat16)
    if lens == "pad":
        qp, kp, vp, seg, _ = fa._pad_to_tile(q, k, v, None)
        dop = torch.nn.functional.pad(do, (0, 0, 0, 0, 0, qp.shape[1] - s))
        return (q, k, v, do), (qp, kp, vp, dop, seg), None, b * h * s * s
    seg = segment_ids(lens, b).float()       # as the C entries take them
    mask = (seg[:, :, None] == seg[:, None, :])[:, None]
    return (q, k, v, do), (q, k, v, do, seg), mask, h * int(mask.sum())


def tile_counts(fa, seg, s, bq, bk=64):
    """(skip, full, masked) tile pairs of ``segment_tile_plan`` at S = s,
    non-causal, summed over the batch rows, at a body's tiles (bq, bk)
    (``segment_tiles``: the forward's and dQ's 128 x 64 at D 64, dK/dV's
    64 x 64)."""
    plan = fa.segment_tile_plan(seg, s, s, bq, bk, False)
    return tuple(int((plan == c).sum())
                 for c in (fa.TILE_SKIP, fa.TILE_FULL, fa.TILE_MASKED))


def segment_timing(fa, gen, shape, lens, label, lib_what):
    """The segment branch of rows 3, 5 and 6 in bf16, non-causal: the
    kernel and its plain version on ``segment_inputs`` beside SDPA on the
    same function (the unpadded inputs; for segments, with the
    block-diagonal boolean mask).  The bound counts the work of the
    function: the unpadded bytes (and the ids) and the (query, key) pairs
    inside the segments; the work the kernels do and the tile classes of
    the wgmma bodies (``segment_tile_plan`` at each body's
    ``segment_tiles``: the forward's and dQ's 128 x 64 tiles, dK / dV's
    64 x 64 at D 64) are printed beside it.  The kernels are timed as
    CUDA-graph replays (the packed varlen launches run for less than the
    wrappers' host cost), their plain versions and SDPA eagerly."""
    b, s, _, h, _, d = shape
    (q, k, v, do), (qp, kp, vp, dop, seg), mask, pairs = segment_inputs(
        fa, gen, shape, lens)
    sp = qp.shape[1]
    tiles = []
    for what, which in (("forward", "fwd"), ("dK/dV", "bwd_dkv"),
                        ("dQ", "bwd_dq")):
        bq, bk = fa.segment_tiles(which, d)
        skip, full, masked = tile_counts(fa, seg, sp, bq, bk)
        done = (full + masked) * bq * bk * h
        tiles.append(f"{what}'s {bq} x {bk} tiles {skip} skipped, {full} "
                     f"full, {masked} masked ({done / 1e6:.1f}M pairs "
                     f"computed)")
    print(f"  {label.strip()}: the mma.sync bodies score "
          f"{b * h * sp * sp / 1e6:.1f}M pairs "
          f"({4 * d * b * h * sp * sp / 1e9:.1f} GFLOP forward), the "
          f"function needs {pairs / 1e6:.1f}M ({4 * d * pairs / 1e9:.1f}); "
          f"per head, summed over the batch rows, the wgmma bodies' "
          + "; ".join(tiles))
    args = (False, 1.0 / np.sqrt(d), 0.0, 0, seg)
    o, lse = fa.flash_attention_fwd(qp, kp, vp, *args)
    delta = delta_of(dop, o)
    lib_fwd, lib_bwd, lib_both = sdpa_times(q, k, v, do, attn_mask=mask)
    q_bytes = b * s * h * d * 2
    stats_bytes, seg_bytes = b * h * s * 4, b * s * 4
    bwd_what = f"{lib_what} backward alone; forward + backward " \
        f"{lib_both:.4f} ms"
    res = {}
    res["fa_fwd_seg"] = report(
        f"flash_attention_fwd{label}",
        graph_ms(lambda i: fa.flash_attention_fwd(qp, kp, vp, *args), 10),
        time_ms(lambda i: fa.flash_attention_fwd_ref(qp, kp, vp, *args), 3,
                warmup=1), lib_fwd,
        4 * q_bytes + stats_bytes + seg_bytes, 4 * d * pairs,
        f"{lib_what} forward")
    res["fa_dkv_seg"] = report(
        f"flash_attention_bwd_dkv{label}",
        graph_ms(lambda i: fa.flash_attention_bwd_dkv(
            qp, kp, vp, dop, lse, delta, *args), 5),
        time_ms(lambda i: fa.flash_attention_bwd_dkv_ref(
            qp, kp, vp, dop, lse, delta, *args), 3, warmup=1), lib_bwd,
        6 * q_bytes + 2 * stats_bytes + seg_bytes, 8 * d * pairs, bwd_what)
    res["fa_dq_seg"] = report(
        f"flash_attention_bwd_dq{label}",
        graph_ms(lambda i: fa.flash_attention_bwd_dq(
            qp, kp, vp, dop, lse, delta, *args), 5),
        time_ms(lambda i: fa.flash_attention_bwd_dq_ref(
            qp, kp, vp, dop, lse, delta, *args), 3, warmup=1), lib_bwd,
        5 * q_bytes + 2 * stats_bytes + seg_bytes, 6 * d * pairs, bwd_what)
    del q, k, v, do, qp, kp, vp, dop, o, lse, delta, mask
    torch.cuda.empty_cache()
    return res


def parent_segment_turns(parent, fa, gen, shape, lens, label):
    """``--parent DIR``: rows 3s, 5s and 6s of another commit's
    ``flash_attention.cu`` (DIR holds its ``csrc``) timed in turns with this
    build's — parent, new, new, parent — on ``segment_inputs``, through the
    C entries (each build with the trailing arguments its source takes,
    ``entry_tail``, and the ids); every output is held against the plain
    version first."""
    import ctypes
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    libs = {"parent": parent_library(parent, "flash_attention"),
            "new": _build.library("flash_attention")}
    tails = {}
    for side, path in (("parent", Path(parent)), ("new", _build.CSRC)):
        types, values = entry_tail(path)
        require(types and types[-1] is ctypes.c_void_p,
                f"the {side} build's C entries take no segment ids")
        tails[side] = (types, values[:-1])
    b, s, _, h, _, d = shape
    _, (qp, kp, vp, dop, seg), _, _ = segment_inputs(fa, gen, shape, lens)
    sp = qp.shape[1]
    geometry = (b, h, h, sp, sp, d)
    sc = 1.0 / np.sqrt(d)
    args = (False, sc, 0.0, 0, seg)
    ro, rlse = fa.flash_attention_fwd_ref(qp, kp, vp, *args)
    p_round = 2.0 ** -8 * fa.flash_attention_fwd_ref(
        qp, kp, vp.abs(), *args)[0].float()
    delta = delta_of(dop, ro)
    rdk, rdv = fa.flash_attention_bwd_dkv_ref(qp, kp, vp, dop, rlse, delta,
                                              *args)
    rdq = fa.flash_attention_bwd_dq_ref(qp, kp, vp, dop, rlse, delta, *args)
    o, lse = torch.empty_like(qp), torch.empty_like(rlse)
    dk, dv, dq = (torch.empty_like(x) for x in (kp, vp, qp))
    tol = TRAIN_TOL[torch.bfloat16]
    for side in ("parent", "new", "new", "parent"):
        lib = libs[side]
        tail = (tails[side][0], tails[side][1] + [seg.data_ptr()])
        calls = {
            "fwd": lambda i: fa_direct(lib, "fwd", (qp, kp, vp, o, lse),
                                       geometry, False, sc, tail),
            "bwd_dkv": lambda i: fa_direct(
                lib, "bwd_dkv", (qp, kp, vp, dop, rlse, delta, dk, dv),
                geometry, False, sc, tail),
            "bwd_dq": lambda i: fa_direct(
                lib, "bwd_dq", (qp, kp, vp, dop, rlse, delta, dq), geometry,
                False, sc, tail)}
        for fn in calls.values():
            fn(0)
        held(f"fwd o   [{side}{label}]", o, ro, tol, p_round)
        held(f"fwd lse [{side}{label}]", lse, rlse, TRAIN_TOL[torch.float32])
        held(f"dk [{side}{label}]", dk, rdk, tol)
        held(f"dv [{side}{label}]", dv, rdv, tol)
        held(f"dq [{side}{label}]", dq, rdq, tol)
        fwd_ms, dkv_ms, dq_ms = (graph_ms(fn, 10) for fn in calls.values())
        print(f"  turn {side}{label}: rows 3s / 5s / 6s {list(shape)}: "
              f"forward {fwd_ms:.4f} ms, dK/dV {dkv_ms:.4f} ms, dQ "
              f"{dq_ms:.4f} ms")
    del qp, kp, vp, dop, ro, rlse, p_round, delta, rdk, rdv, rdq, o, lse
    del dk, dv, dq
    torch.cuda.empty_cache()


# ViT-L/16's attention at 384 px (phase 3g): B 32, 577 tokens, 16 heads of
# 64; and a packed varlen batch of 2 rows of 4,096 tokens in segments of
# 5..300
VIT_ATTN_SHAPE = (32, 577, 577, 16, 16, 64)
VARLEN_SHAPE = (2, 4096, 4096, 16, 16, 64)


def phase_segment_timing(parent=None):
    """Phase 5d: the segment branch of rows 3, 5 and 6 at ViT-L/16's
    attention shape (phase 3g: 577 rows padded to 640), and at a packed
    varlen shape beside SDPA with the block-diagonal mask; with ``parent``
    (another commit's ``csrc``) that build's rows 3s, 5s and 6s in turns
    with these at both shapes.  Returns the ViT shape's numbers."""
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(22)
    varlen = packed_lengths(VARLEN_SHAPE[1])
    res = segment_timing(fa, gen, VIT_ATTN_SHAPE, "pad", " (segments, ViT)",
                         "SDPA on the unpadded [32, 577, 16, 64]")
    segment_timing(fa, gen, VARLEN_SHAPE, varlen, " (segments, varlen)",
                   "SDPA with the block-diagonal boolean mask")
    if parent is not None:
        print(f"  rows 3s, 5s and 6s against the build of {parent}, in "
              f"turns:")
        parent_segment_turns(parent, fa, gen, VIT_ATTN_SHAPE, "pad",
                             " (ViT)")
        parent_segment_turns(parent, fa, gen, VARLEN_SHAPE, varlen,
                             " (varlen)")
    return res


# Design steps of the bf16 forward (compile-time settings of
# flash_attention.cu: FA_FWD_HP_DESIGN makes every launch without segments
# take one design where it fits, FA_FWD_HP_STAGES caps the ring; the
# shipped build first): each design that the dispatch does not pick at
# W 64, and the shipped picks with a deeper ring where it fits
FWD_VARIANTS = (
    ("shipped: fwd_design's pick", ()),
    ("a block per q tile, 64 keys", ("-DFA_FWD_HP_DESIGN=0",)),
    ("a block per q tile, 128 keys", ("-DFA_FWD_HP_DESIGN=1",)),
    ("persistent, 64 keys", ("-DFA_FWD_HP_DESIGN=2",)),
    ("shipped pick, a ring of up to 6", ("-DFA_FWD_HP_STAGES=6",)),
)
# (shape, causal, dropout rate) of the forward's design steps: 3c's
# launch, 3d's at rate 0 and 0.1, 3h's three, and ViT's sequence without
# segments
FWD_DESIGN_SHAPES = (((8, 2048, 2048, 16, 16, 64), True, 0.0),
                     ((64, 512, 512, 12, 12, 64), False, 0.0),
                     ((64, 512, 512, 12, 12, 64), False, 0.1),
                     ((8, 4096, 4096, 8, 8, 40), False, 0.0),
                     ((8, 1024, 1024, 8, 8, 80), False, 0.0),
                     ((8, 256, 256, 8, 8, 160), False, 0.0),
                     ((32, 640, 640, 16, 16, 64), False, 0.0))


def build_variants(variants, names=("flash_attention",)):
    """{library name: path} of the libraries ``names`` for each (what,
    defines) entry, one ``nvcc`` each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build
    with ThreadPoolExecutor(len(variants)) as pool:
        return list(pool.map(
            lambda var: _build.build_all(list(names), var[1]), variants))


def forward_design_steps(fa, gen, variants, shapes, turns=2):
    """One line per entry of ``variants`` (``FWD_VARIANTS``) at each (shape,
    causal, dropout rate) of ``shapes``, in ``turns`` turns: the variant's
    forward held against the plain version (first turn), then timed as
    CUDA-graph replays over ``attention_copies``, with the design it ran
    (``kernel_fwd_design``) and ptxas's registers and spills of its
    forward at that width and rate.  A measurement only: the port loads
    the shipped build, which is put back however this ends."""
    import ctypes

    from paddle_tpu_torch.ops import _build
    names = [_build.width_library("flash_attention",
                                  fa.head_width(shape[-1]))
             for shape, _, _ in shapes]
    t0 = time.perf_counter()
    paths = build_variants(variants, sorted(set(names)))
    print(f"  built {len(variants)} variants of {sorted(set(names))} in "
          f"{time.perf_counter() - t0:.1f} s")
    tol = TRAIN_TOL[torch.bfloat16]
    for (shape, causal, rate), name in zip(shapes, names):
        b, s_q, s_k, hq, _, d = shape
        w = fa.head_width(d)
        args = (causal, 1.0 / np.sqrt(d), rate, 777 if rate > 0 else 0)
        copies = attention_copies(gen, shape)
        n = len(copies)
        q, k, v, _ = copies[0]
        ro, _ = fa.flash_attention_fwd_ref(q, k, v, *args)
        p_round = 2.0 ** -8 * fa.flash_attention_fwd_ref(
            q, k, v.abs(), *args)[0].float()
        shipped = _build.library(name)
        tag = f"{list(shape)} causal={causal} rate {rate:g}"
        try:
            for turn in range(1, turns + 1):
                for (what, _), path in zip(variants, paths):
                    _build._LIBS[name] = ctypes.CDLL(str(path[name]))
                    if turn == 1:
                        o, _ = fa.flash_attention_fwd(q, k, v, *args)
                        held(f"fwd o [{what}] {tag}", o, ro, tol, p_round)
                        del o
                    ms = graph_ms(lambda i: fa.flash_attention_fwd(
                        *copies[i % n][:3], *args), 10)
                    bq, bk, persistent = fa.FWD_DESIGNS[fa.kernel_fwd_design(
                        b, hq, s_q, s_k, d, causal, False)]
                    regs = ", ".join(
                        f"{r} registers, {st} B spilled"
                        for kern, a, r, st, _ in ptxas_lines(path[name])
                        if kern == "fa_fwd_wgmma_kernel"
                        and template_args(a) == [w, bk, int(persistent), 0,
                                                 int(rate > 0)])
                    print(f"  design step of the forward, turn {turn}, "
                          f"{what}, {tag}: {ms:.4f} ms ({bq} rows x {bk} "
                          f"keys{', persistent' * persistent}; {regs})")
        finally:
            _build._LIBS[name] = shipped
        del copies, q, k, v, ro, p_round
        torch.cuda.empty_cache()


# (shape, causal) of row 3's turns against the parent beside the steps'
# shapes: 3d's at rate 0, and the widths that no model of the repo takes
PARENT_FWD_SHAPES = (((64, 512, 512, 12, 12, 64), False),
                     *(((8, 1024, 1024, 8, 8, d), False)
                       for d in (32, 96, 128, 192, 256)),
                     ((4, 2048, 2048, 16, 4, 128), True))


def parent_forward_turns(parent, fa, gen, shapes):
    """``--parent DIR``: row 3 (the forward alone) of another commit's
    flash-attention libraries (DIR holds its ``csrc``; an older build's bf16
    forward without segments runs mma.sync) timed in turns with this
    build's — parent, new, new, parent — at each (shape, causal) of
    ``shapes`` through the C entries, as CUDA-graph replays over
    ``attention_copies``; each output held against the plain version
    first."""
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    for shape, causal in shapes:
        b, s_q, s_k, hq, hkv, d = shape
        name = _build.width_library("flash_attention", fa.head_width(d))
        libs = {"parent": parent_library(parent, name),
                "new": _build.library(name)}
        tails = {side: entry_tail(path) for side, path in
                 (("parent", Path(parent)), ("new", _build.CSRC))}
        geometry = (b, hq, hkv, s_q, s_k, d)
        copies = attention_copies(gen, shape)
        n = len(copies)
        sc = 1.0 / np.sqrt(d)
        q, k, v, _ = copies[0]
        ro, rlse = fa.flash_attention_fwd_ref(q, k, v, causal, sc)
        p_round = 2.0 ** -8 * fa.flash_attention_fwd_ref(
            q, k, v.abs(), causal, sc)[0].float()
        o, lse = torch.empty_like(q), torch.empty_like(rlse)
        line = []
        for side in ("parent", "new", "new", "parent"):
            lib, tail = libs[side], tails[side]

            def call(i):
                fa_direct(lib, "fwd", (*copies[i % n][:3], o, lse), geometry,
                          causal, sc, tail)
            call(0)
            held(f"fwd o   [{side}] {list(shape)} causal={causal}", o, ro,
                 TRAIN_TOL[torch.bfloat16], p_round)
            line.append(f"{side} {graph_ms(call, 10):.4f}")
        print(f"  turns of row 3 at {list(shape)} causal={causal} (width "
              f"{fa.head_width(d)}): " + ", ".join(line) + " ms")
        del copies, q, k, v, ro, rlse, p_round, o, lse
        torch.cuda.empty_cache()


def c_entry(lib, name, n_ptrs, n_ints, n_floats=0):
    """The C entry ``name`` of a loaded kernel library, with its argument
    types (pointers, ints, floats, then the stream) set."""
    import ctypes
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + \
        [ctypes.c_float] * n_floats + [ctypes.c_void_p]
    return fn


def rms_fwd_direct(lib, x, w, eps=1e-5):
    """One launch of ``rms_norm_fwd_launch`` from ``lib`` on bf16 rows and
    weight: the C entry alone, for timing builds against each other."""
    n, h = x.shape
    out = torch.empty_like(x)
    inv = torch.empty(n, dtype=torch.float32, device=x.device)
    err = c_entry(lib, "rms_norm_fwd_launch", 4, 4, 1)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), inv.data_ptr(), n, h, 1,
        1, eps, torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"rms_norm_fwd_launch: CUDA error {err}")
    return out, inv


def ln_bwd_direct(lib, x, w, mu, inv, g, partial):
    """One launch of ``layer_norm_bwd_launch`` from ``lib`` on bf16 rows and
    weight, with a partials buffer of ``partial``'s rows (enough for either
    build's grid): the C entry alone, for timing builds against each
    other."""
    n, h = x.shape
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(w)
    err = c_entry(lib, "layer_norm_bwd_launch", 9, 4)(
        x.data_ptr(), w.data_ptr(), mu.data_ptr(), inv.data_ptr(),
        g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
        partial.data_ptr(), n, h, 1, 1,
        torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"layer_norm_bwd_launch: CUDA error {err}")
    return dx, dw, db


def rotated(gen, n_copies, *shape):
    """``n_copies`` bf16 tensors of random normal values: inputs that timed
    replays take in turn, so that no replay finds its rows in the 50 MB L2
    where the previous one left them."""
    return [torch.randn(*shape, generator=gen, device="cuda").bfloat16()
            for _ in range(n_copies)]


def parent_norm_turns(parent, fu, gen, N=16384, H=1024):
    """``--parent DIR``: ``rms_norm.cu`` and ``layer_norm.cu`` of another
    commit (DIR holds its ``csrc``), built with the same flags and timed in
    turns with the shipped build — parent, new, new, parent — on the same
    rotated inputs: the RMSNorm forward at N x H and the LayerNorm backward
    at ``ERNIE_LN_ROWS`` (bf16, CUDA-graph replays of the C entry).  Every
    output is held against the plain version first."""
    import ctypes
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    names = ["rms_norm", "layer_norm"]
    paths = {"parent": _build.build_all(names, csrc=Path(parent)),
             "new": _build.build_all(names)}
    libs = {side: {n: ctypes.CDLL(str(p[n])) for n in names}
            for side, p in paths.items()}
    tol = TRAIN_TOL[torch.bfloat16]
    xr = rotated(gen, 2, N, H)
    wr = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).bfloat16()
    want_r = fu.rms_norm_fwd_ref(xr[0], wr, 1e-5)
    n, h = ERNIE_LN_ROWS
    xl, gl = rotated(gen, 2, n, h), rotated(gen, 2, n, h)
    wl = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).bfloat16()
    stats = [fu.layer_norm_fwd_ref(x, wl, wl, 1e-12)[1:] for x in xl]
    want_l = fu.layer_norm_bwd_ref(xl[0], wl, *stats[0], gl[0])
    # the parent's grid writes 2 ceil(n / 64) partial rows, this one 2 per
    # block of a grid sized to the card
    parts = max(2 * -(-n // 64), 2 * _build.library(
        "layer_norm").layer_norm_bwd_partials(n))
    partial = torch.empty(parts, h, dtype=torch.float32, device="cuda")
    for side in ("parent", "new", "new", "parent"):
        rms, ln = libs[side]["rms_norm"], libs[side]["layer_norm"]
        out, inv = rms_fwd_direct(rms, xr[0], wr)
        held(f"rms out [{side}]", out, want_r[0], tol)
        held(f"rms inv [{side}]", inv, want_r[1], TRAIN_TOL[torch.float32])
        got = ln_bwd_direct(ln, xl[0], wl, *stats[0], gl[0], partial)
        for what, a, b in zip(("dx", "dw", "db"), got, want_l):
            held(f"ln {what} [{side}]", a, b, tol)
        rms_ms = graph_ms(lambda i: rms_fwd_direct(rms, xr[i % 2], wr), 100)
        ln_ms = graph_ms(lambda i: ln_bwd_direct(
            ln, xl[i % 2], wl, *stats[i % 2], gl[i % 2], partial), 100)
        print(f"  turn {side}: RMSNorm fwd [{N}, {H}] {rms_ms:.4f} ms, "
              f"LayerNorm bwd [{n}, {h}] {ln_ms:.4f} ms")
    del xr, xl, gl, stats, want_r, want_l, partial, libs
    torch.cuda.empty_cache()


def entry_tail(csrc, rate=0.0, seed=0):
    """(ctypes types, values) of the arguments that the C entries of the
    ``flash_attention.cu`` in ``csrc`` take after sm_scale, read off its
    source (and ``flash_attention.cuh``, where the entries live from the
    head-width slice on): the dropout arguments (of ``rate`` and ``seed``)
    from the dropout branch on, then a null segment pointer from the
    segment branch on."""
    import ctypes

    from paddle_tpu_torch.ops import flash_attention as fa
    source = "".join((csrc / f).read_text()
                     for f in ("flash_attention.cu", "flash_attention.cuh")
                     if (csrc / f).exists())
    types, values = [], []
    if "unsigned thresh" in source:
        types += [ctypes.c_uint, ctypes.c_float, ctypes.c_uint,
                  ctypes.c_uint]
        values += list(fa._dropout_args(rate, seed))
    else:
        require(rate == 0.0, f"{csrc} has no dropout branch")
    if "const void* seg" in source:
        types.append(ctypes.c_void_p)
        values.append(None)
    return types, values


def fa_direct(lib, which, tensors, geometry, causal, sc, tail):
    """One launch of ``flash_attention_<which>_launch`` from ``lib`` on
    bf16 [B, S, H, D] tensors (inputs, then the outputs it fills); the C
    entry alone, with the trailing arguments ``tail`` of that build
    (``entry_tail``)."""
    import ctypes

    from paddle_tpu_torch.ops import flash_attention as fa
    fn = getattr(lib, f"flash_attention_{which}_launch")
    fn.restype = ctypes.c_int
    four_d = [t for t in tensors if t.dim() == 4]
    strides = fa._strides(*four_d)
    types, values = tail
    fn.argtypes = ([ctypes.c_void_p] * (len(tensors) + 1)
                   + [ctypes.c_int] * 8 + [ctypes.c_float] + types
                   + [ctypes.c_void_p])
    err = fn(*[t.data_ptr() for t in tensors],
             ctypes.cast(strides, ctypes.c_void_p), *geometry, 1,
             int(causal), sc, *values,
             torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"flash_attention_{which}_launch: CUDA error {err}")


def parent_library(parent, name):
    """Library ``name`` built from another commit's sources (``parent``, a
    ``csrc`` directory) with the same flags, loaded."""
    import ctypes
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    return ctypes.CDLL(str(_build.build_all([name], csrc=Path(parent))[name]))


def parent_attention_turns(parent, fa, gen, shape, causal, rate=0.0):
    """``--parent DIR``: rows 3, 5 and 6 of another commit's flash-attention
    library of ``shape``'s head width (DIR holds its ``csrc``) timed in
    turns with this build's — parent, new, new, parent — at ``rate``
    (dropout under one seed: rows 3d, 5d and 6d) through their C entries
    (each build with the trailing arguments its source takes,
    ``entry_tail``), as CUDA-graph replays over ``attention_copies``; every
    output is held against the plain version first."""
    from pathlib import Path

    from paddle_tpu_torch.ops import _build
    b, s_q, s_k, hq, hkv, d = shape
    name = _build.width_library("flash_attention", fa.head_width(d))
    libs = {"parent": parent_library(parent, name),
            "new": _build.library(name)}
    seed = 4321 if rate > 0 else 0
    tails = {side: entry_tail(path, rate, seed) for side, path in
             (("parent", Path(parent)), ("new", _build.CSRC))}
    geometry = (b, hq, hkv, s_q, s_k, d)
    copies = attention_copies(gen, shape)
    n = len(copies)
    sc = 1.0 / np.sqrt(d)
    args = (causal, sc, rate, seed)
    q, k, v, do = copies[0]
    ro, rlse = fa.flash_attention_fwd_ref(q, k, v, *args)
    p_round = 2.0 ** -8 * fa.flash_attention_fwd_ref(
        q, k, v.abs(), *args)[0].float()
    delta = delta_of(do, ro)
    want = (*fa.flash_attention_bwd_dkv_ref(q, k, v, do, rlse, delta, *args),
            fa.flash_attention_bwd_dq_ref(q, k, v, do, rlse, delta, *args))
    stats = [(rlse, delta)]
    for c in copies[1:]:
        o, lse = fa.flash_attention_fwd(*c[:3], *args)
        stats.append((lse, delta_of(c[3], o)))
    o, lse = torch.empty_like(q), torch.empty_like(rlse)
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    tol = TRAIN_TOL[torch.bfloat16]
    for side in ("parent", "new", "new", "parent"):
        lib, tail = libs[side], tails[side]
        calls = {
            "fwd": lambda i: fa_direct(lib, "fwd", (*copies[i % n][:3], o,
                                                    lse), geometry, causal,
                                       sc, tail),
            "bwd_dkv": lambda i: fa_direct(
                lib, "bwd_dkv", (*copies[i % n], *stats[i % n], dk, dv),
                geometry, causal, sc, tail),
            "bwd_dq": lambda i: fa_direct(
                lib, "bwd_dq", (*copies[i % n], *stats[i % n], dq), geometry,
                causal, sc, tail)}
        for fn in calls.values():
            fn(0)
        held(f"fwd o   [{side}]", o, ro, tol, p_round)
        held(f"fwd lse [{side}]", lse, rlse, TRAIN_TOL[torch.float32])
        for what, got, ref in zip(("dk", "dv", "dq"), (dk, dv, dq), want):
            held(f"{what} [{side}]", got, ref, tol)
        line = ", ".join(f"{what} {graph_ms(fn, 10):.4f} ms"
                         for what, fn in calls.items())
        print(f"  turn {side}: rows 3/5/6 at rate {rate:g} {list(shape)} "
              f"causal={causal}, graph replays over {n} input copies: "
              f"{line}")
    del copies, stats, ro, rlse, p_round, delta, want, o, lse, dk, dv, dq
    torch.cuda.empty_cache()


def parent_step_turns(parent, fa, which, warmup=2, steps=10):
    """``--parent DIR``: the train step of phase ``which`` — "3c" (the 271M
    LLaMA, B 8 x S 2,048), "3d" (ERNIE-3.0-base MLM, B 64 x S 512, both
    dropouts at ``DROPOUT_RATE``) or "3h" (the SD-1.5 UNet, B 8) — on one
    model, timed in turns — parent, new, new, parent — with the
    flash-attention libraries of its head widths swapped between another
    commit's build (DIR holds its ``csrc``) and this one; every other
    kernel is this build's.  Each turn runs ``warmup`` steps, then
    ``steps`` timed ones, and prints ms per step and its last loss.  The
    shipped libraries are put back however this ends."""
    from paddle_tpu_torch.ops import _build
    if which == "3c":
        cfg = train_config()
        step, _, _ = make_train_step(cfg, torch.bfloat16, True)
        batch = train_batch(cfg, 8, 2048)
        dims = (cfg.hidden_size // cfg.num_attention_heads,)
        what = "3c LLaMA train step, B=8 S=2048"
    elif which == "3d":
        cfg = ernie_config()
        step, _, _ = make_ernie_step(cfg, torch.bfloat16, True)
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (64, 512))
                               .astype(np.int32)).cuda()
        batch = (ids, ids)
        dims = (cfg.hidden_size // cfg.num_attention_heads,)
        what = f"3d MLM step at dropout {DROPOUT_RATE}, B=64 S=512"
    else:
        step, _, _ = make_unet_step(torch.bfloat16, True)
        batch = unet_batch(8, torch.bfloat16)
        dims = UNET_HEAD_DIMS
        what = "3h UNet train step, B=8"
    names = sorted({_build.width_library("flash_attention", fa.head_width(d))
                    for d in dims})
    libs = {"parent": {n: parent_library(parent, n) for n in names},
            "new": {n: _build.library(n) for n in names}}
    try:
        for side in ("parent", "new", "new", "parent"):
            _build._LIBS.update(libs[side])
            for _ in range(warmup):
                step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step(batch)[0] for _ in range(steps)]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
            loss = float(losses[-1])
            require(np.isfinite(loss), f"{which} turn {side}: loss {loss}")
            print(f"  turn {side}: {what}: {ms:.2f} ms per step over "
                  f"{steps} steps, last loss {loss:.4f}")
    finally:
        _build._LIBS.update(libs["new"])
    del step, batch
    torch.cuda.empty_cache()


def library_call(what, fn, want, tol):
    """A PyTorch call for the same function as a kernel, to be timed as its
    ``library_ms``: its outputs held against the kernel's plain version
    first (at the kernel's own tolerance).  Returns ``fn``, or None, with
    the reason printed, when the card's torch lacks the op, refuses these
    inputs or computes something else."""
    try:
        got = fn(0)
        torch.cuda.synchronize()
    except (AttributeError, NotImplementedError, RuntimeError) as e:
        print(f"  library {what}: this torch does not run it on these "
              f"inputs ({type(e).__name__}: "
              f"{str(e).splitlines()[0][:100]})")
        return None
    atol, rtol, _ = tol
    errs = [(a.float() - b.float()).abs() for a, b in zip(got, want)]
    ok = all(bool((e <= atol + rtol * b.float().abs()).all())
             for e, b in zip(errs, want))
    print(f"  library {what}: "
          + ("equals" if ok else "DIFFERS from")
          + " the plain version (max abs err "
          + ", ".join(f"{e.max().item():.3e}" for e in errs)
          + f"; tol {atol:g} + {rtol:g}*|ref|)")
    return fn if ok else None


def phase_train_timing(B=8, S=2048, Hq=16, D=64, N=16384, H=1024,
                       parent=None):
    """Rows 3-8 at the train shape (bf16, causal; RMSNorm rows N x H): the
    kernel, its plain version, the bound and the library call (timed here
    only; the port never calls it); rows 3, 5 and 6 also at ERNIE's
    attention shape (phase 3d, non-causal), the forward's design steps
    (``FWD_VARIANTS``), and with ``parent`` the turns of
    :func:`parent_attention_turns` (rows 3/5/6 at the train shape, rows
    3d/5d/6d at 3d's at dropout 0.1), :func:`parent_forward_turns`
    (``PARENT_FWD_SHAPES``), :func:`parent_step_turns` (3c, 3d) and
    :func:`parent_norm_turns`.  Row 8's library call is the backward alone
    (``aten._fused_rms_norm_backward``), with ``F.rms_norm`` forward +
    backward printed beside it."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused as fu

    gen = torch.Generator(device="cuda").manual_seed(21)
    dt = torch.bfloat16
    res = attention_timing(fa, gen, (B, S, S, Hq, Hq, D), True)
    print("  at ERNIE's attention shape (phase 3d), rate 0:")
    attention_timing(fa, gen, ERNIE_ATTN_SHAPE, False, " (ERNIE)")
    print(f"  at ERNIE's attention shape (phase 3d), dropout rate "
          f"{DROPOUT_RATE} (the dropout rows), beside SDPA with dropout_p="
          f"{DROPOUT_RATE}:")
    drop = attention_timing(fa, gen, ERNIE_ATTN_SHAPE, False,
                            f" (ERNIE, dropout {DROPOUT_RATE})", DROPOUT_RATE)
    res.update({k + "_drop": v for k, v in drop.items()})
    print("  design steps of the forward (3c, 3d, 3h and ViT's "
          "shapes):")
    forward_design_steps(fa, gen, FWD_VARIANTS, FWD_DESIGN_SHAPES)
    if parent is not None:
        print(f"  rows 3, 5 and 6 at rate 0 against the build of {parent}, "
              f"in turns:")
        parent_attention_turns(parent, fa, gen, (B, S, S, Hq, Hq, D), True)
        print(f"  rows 3d, 5d and 6d (ERNIE's attention shape, phase 3d, "
              f"dropout {DROPOUT_RATE}) against the build of {parent}, in "
              f"turns:")
        parent_attention_turns(parent, fa, gen, ERNIE_ATTN_SHAPE, False,
                               DROPOUT_RATE)
        print(f"  row 3 at 3d's shape at rate 0 and at the widths no model "
              f"takes against the build of {parent}, in turns:")
        parent_forward_turns(parent, fa, gen, PARENT_FWD_SHAPES)
        for which in ("3c", "3d"):
            print(f"  phase {which}'s train step on the flash-attention "
                  f"library of {parent} and on this one, in turns:")
            parent_step_turns(parent, fa, which)
        print(f"  rows 7 and 13 against the build of {parent}, in turns:")
        parent_norm_turns(parent, fu, gen, N, H)
    elt = 2
    stats_bytes = B * Hq * S * 4

    # rows 4, 7 and 8 run for tens of us, less than a wrapper's host cost:
    # they, their plain versions and the library calls are timed as CUDA
    # graph replays
    # the standalone repack: 4 strided stats buffers in rotation
    lse3s = [torch.randn(B * Hq, S, 2, generator=gen, device="cuda")[..., 1:]
             for _ in range(4)]
    res["pack_lse"] = report(
        "pack_lse", graph_ms(lambda i: fa.pack_lse(lse3s[i % 4]), 200),
        graph_ms(lambda i: fa.pack_lse_ref(lse3s[i % 4]), 200),
        graph_ms(lambda i: lse3s[i % 4][..., 0].contiguous(), 200),
        2 * stats_bytes, 0, "lse3[..., 0].contiguous()")

    # row 7's x (33.6 MB) in 2 rotated copies, for it and its plain and
    # library calls
    xs = rotated(gen, 2, N, H)
    x = xs[0]
    w = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(dt)
    g = torch.randn(N, H, generator=gen, device="cuda").to(dt)
    out, inv = fu.rms_norm_fwd(x, w, 1e-5)
    row_bytes = N * H * elt
    res["rms_fwd"] = report(
        "rms_norm_fwd", graph_ms(lambda i: fu.rms_norm_fwd(xs[i % 2], w,
                                                             1e-5), 100),
        graph_ms(lambda i: fu.rms_norm_fwd_ref(xs[i % 2], w, 1e-5), 20),
        graph_ms(lambda i: F.rms_norm(xs[i % 2], (H,), w, 1e-5), 100),
        2 * row_bytes + H * elt + N * 4, 4 * N * H,
        "F.rms_norm forward, rotated x")
    xg = x.detach().requires_grad_(True)
    wg = w.detach().requires_grad_(True)

    def rms_fwd_bwd(i):
        torch.autograd.grad(F.rms_norm(xg, (H,), wg, 1e-5), (xg, wg), g)

    fwd_bwd = graph_ms(rms_fwd_bwd, 50)
    print(f"  rms_norm_bwd: F.rms_norm forward + backward through autograd "
          f"{fwd_bwd:.4f} ms")
    lib = library_call(
        "aten._fused_rms_norm_backward (row 8)",
        lambda i: torch.ops.aten._fused_rms_norm_backward(
            g, x, [H], inv.view(N, 1), w, [True, True]),
        fu.rms_norm_bwd_ref(x, w, inv, g), TRAIN_TOL[dt])
    res["rms_bwd"] = report(
        "rms_norm_bwd", graph_ms(lambda i: fu.rms_norm_bwd(x, w, inv, g), 100),
        graph_ms(lambda i: fu.rms_norm_bwd_ref(x, w, inv, g), 20),
        fwd_bwd if lib is None else graph_ms(lib, 100),
        3 * row_bytes + 2 * H * elt + N * 4, 8 * N * H,
        "F.rms_norm forward + backward" if lib is None
        else "aten._fused_rms_norm_backward")
    del xs, x, g, out, inv, xg
    torch.cuda.empty_cache()
    return res


def library_adamw_takes_mixed(lib_args):
    """Whether ``torch._fused_adamw_`` computes AdamW right on a bf16
    parameter with f32 moments: one first step on a short tensor, against
    the port's plain version (a refusal or a wrong answer both say no)."""
    from paddle_tpu_torch.ops import fused as fu
    gen = torch.Generator(device="cuda").manual_seed(23)
    p = torch.randn(4096, generator=gen, device="cuda").bfloat16()
    g = torch.randn(4096, generator=gen, device="cuda").bfloat16()
    m, v = torch.zeros(4096, device="cuda"), torch.zeros(4096, device="cuda")
    want = fu.adamw_update_ref(p, g, m, v, lr=lib_args["lr"], step=1,
                               weight_decay=lib_args["weight_decay"])
    try:
        torch._fused_adamw_([p], [g], [m], [v], [],
                            [torch.tensor(1.0, device="cuda")], **lib_args)
    except RuntimeError:
        return False
    return bool(torch.allclose(p.float(), want[0].float(), rtol=1e-2,
                               atol=1e-3)
                and torch.allclose(m, want[1], rtol=1e-5, atol=1e-7)
                and torch.allclose(v, want[2], rtol=1e-5, atol=1e-9))


def phase_fused_timing():
    """Phase 5c: rows 9-13 at the phase-3d/3e shapes (bf16): the kernel,
    its plain version, the bound (bytes over 3.35 TB/s; operations, f32 on
    the CUDA cores, over 67 TFLOP/s) and the library call for the same
    function (timed here only; the port never calls it): for the backward
    kernels (rows 11, 13) the backward alone (``aten._softmax_backward_data``,
    ``aten.native_layer_norm_backward``), with ``torch.softmax`` /
    ``F.layer_norm`` forward + backward printed beside it.  Row 13 and its
    plain and library calls take 2 rotated copies of x and g.  The row
    kernels run for tens of us, so they and their plain and library calls
    are timed as CUDA-graph replays; AdamW over all 149.3M parameters, as
    one flat tensor, is timed eager."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fused as fu

    gen = torch.Generator(device="cuda").manual_seed(22)
    dt, elt, res = torch.bfloat16, 2, {}
    n, h = ERNIE_LN_ROWS
    xs, gs = rotated(gen, 2, n, h), rotated(gen, 2, n, h)
    x, g = xs[0], gs[0]
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
    b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(dt)
    stats = [fu.layer_norm_fwd(t, w, b, 1e-12)[1:] for t in xs]
    row_bytes = n * h * elt
    res["ln_fwd"] = report(
        "layer_norm_fwd", graph_ms(lambda i: fu.layer_norm_fwd(
            x, w, b, 1e-12), 100),
        graph_ms(lambda i: fu.layer_norm_fwd_ref(x, w, b, 1e-12), 20),
        graph_ms(lambda i: F.layer_norm(x, (h,), w, b, 1e-12), 100),
        2 * row_bytes + 2 * h * elt + 2 * n * 4, 8 * n * h,
        "F.layer_norm forward", F32_FLOP_PER_S)
    xg, wg, bg = (t.detach().requires_grad_(True) for t in (x, w, b))

    def ln_fwd_bwd(i):
        torch.autograd.grad(F.layer_norm(xg, (h,), wg, bg, 1e-12),
                            (xg, wg, bg), g)

    fwd_bwd = graph_ms(ln_fwd_bwd, 50)
    print(f"  layer_norm_bwd: F.layer_norm forward + backward through "
          f"autograd {fwd_bwd:.4f} ms")
    lib = library_call(
        "aten.native_layer_norm_backward (row 13)",
        lambda i: torch.ops.aten.native_layer_norm_backward(
            gs[i % 2], xs[i % 2], [h], stats[i % 2][0].view(n, 1),
            stats[i % 2][1].view(n, 1), w, b, [True, True, True]),
        fu.layer_norm_bwd_ref(x, w, *stats[0], g), TRAIN_TOL[dt])
    res["ln_bwd"] = report(
        "layer_norm_bwd", graph_ms(lambda i: fu.layer_norm_bwd(
            xs[i % 2], w, *stats[i % 2], gs[i % 2]), 100),
        graph_ms(lambda i: fu.layer_norm_bwd_ref(
            xs[i % 2], w, *stats[i % 2], gs[i % 2]), 20),
        fwd_bwd if lib is None else graph_ms(lib, 100),
        3 * row_bytes + 3 * h * elt + 2 * n * 4, 12 * n * h,
        "F.layer_norm forward + backward" if lib is None
        else "aten.native_layer_norm_backward, rotated x and g",
        F32_FLOP_PER_S)
    del xs, gs, x, g, xg, stats

    rows, hs = int(np.prod(SOFTMAX_SHAPE[:-1])), SOFTMAX_SHAPE[-1]
    xs = (2 * torch.randn(rows, hs, generator=gen, device="cuda")).to(dt)
    gs = torch.randn(rows, hs, generator=gen, device="cuda").to(dt)
    o = fu.softmax_fwd(xs)
    s_bytes = rows * hs * elt
    res["softmax_fwd"] = report(
        "softmax_fwd", graph_ms(lambda i: fu.softmax_fwd(xs), 100),
        graph_ms(lambda i: fu.softmax_fwd_ref(xs), 20),
        graph_ms(lambda i: torch.softmax(xs, dim=-1), 100),
        2 * s_bytes, 5 * rows * hs, "torch.softmax forward", F32_FLOP_PER_S)
    xsg = xs.detach().requires_grad_(True)

    def softmax_fwd_bwd(i):
        torch.autograd.grad(torch.softmax(xsg, dim=-1), xsg, gs)

    fwd_bwd = graph_ms(softmax_fwd_bwd, 50)
    print(f"  softmax_bwd: torch.softmax forward + backward through autograd "
          f"{fwd_bwd:.4f} ms")
    lib = library_call(
        "aten._softmax_backward_data (row 11)",
        lambda i: (torch.ops.aten._softmax_backward_data(gs, o, -1, dt),),
        (fu.softmax_bwd_ref(o, gs),), TRAIN_TOL[dt])
    res["softmax_bwd"] = report(
        "softmax_bwd", graph_ms(lambda i: fu.softmax_bwd(o, gs), 100),
        graph_ms(lambda i: fu.softmax_bwd_ref(o, gs), 20),
        fwd_bwd if lib is None else graph_ms(lib, 100), 3 * s_bytes,
        4 * rows * hs, "torch.softmax forward + backward" if lib is None
        else "aten._softmax_backward_data", F32_FLOP_PER_S)
    del xs, gs, o, xsg
    torch.cuda.empty_cache()

    N = ERNIE_BASE_PARAMS
    p = (0.02 * torch.randn(N, generator=gen, device="cuda")).to(dt)
    gp = (1e-3 * torch.randn(N, generator=gen, device="cuda")).to(dt)
    m = torch.zeros(N, device="cuda")
    v = torch.zeros(N, device="cuda")
    pows = dict(beta1_pow=torch.tensor(0.9, device="cuda"),
                beta2_pow=torch.tensor(0.999, device="cuda"))
    hyper = dict(lr=1e-4, weight_decay=0.01)
    kern = time_ms(lambda i: fu.adamw_update(p, gp, m, v, **hyper, **pows), 20)
    plain = time_ms(lambda i: fu.adamw_update_ref(p, gp, m, v, **hyper,
                                                  **pows), 3, warmup=1)
    step = torch.tensor(1.0, device="cuda")
    lib_args = dict(lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.01,
                    eps=1e-8, amsgrad=False, maximize=False)
    if library_adamw_takes_mixed(lib_args):
        lib_what = "torch._fused_adamw_, bf16 p and g, f32 m and v"
        lib_t = ([p], [gp], [m], [v])
    else:
        lib_what = "torch._fused_adamw_ over f32 copies of p and g (it " \
                   "does not take bf16 p with f32 moments)"
        lib_t = ([p.float()], [gp.float()], [m], [v])
    lib = time_ms(lambda i: torch._fused_adamw_(*lib_t, [], [step],
                                                **lib_args), 20)
    res["adamw"] = report(
        f"adamw_update [{N:,}]", kern, plain, lib, 22 * N, 15 * N, lib_what,
        F32_FLOP_PER_S)
    return res


# -- phase 2e: rows 1-6 at every head width ----------------------------------
# head dims of rows 3/5/6 that reach every compiled width of
# ``flash_attention.cuh`` (32, 48, 64, 80, 96, 128, 160, 192, 256), off-width
# ones included (24, 40, 56, 72, 112, 176, 200; 64 and 128 themselves are
# phase 2b's), and SD-1.5's 40 / 80 / 160
HEAD_DIMS_2E = (24, 40, 56, 72, 80, 96, 112, 160, 176, 200, 256)
UNET_HEAD_DIMS = (40, 80, 160)
# [B, S, S, heads, heads, d] of SD-1.5's self-attention at B 8 (phase 3h)
UNET_ATTN_SHAPES = ((8, 4096, 4096, 8, 8, 40), (8, 1024, 1024, 8, 8, 80),
                    (8, 256, 256, 8, 8, 160))
# rows 1-2 at head dims off 64 / 128 (40 and 256 also take the 8-byte copies
# of int8 / fp8 rows and the widest tile)
RAGGED_HEAD_DIMS = (40, 80, 96, 256)


def head_keys(d):
    return tuple(f"{k}_d{d}" for k in ("fa_fwd", "fa_dkv", "fa_dq"))


def head_dim_cases(d):
    """Rows 3/5/6 at head dim d: bf16 and f32, causal at S 200 (partial
    tiles) and non-causal with s_q < s_k; GQA 8:2 at the UNet's dims."""
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        cases += [(f"D={d} S=200", (2, 200, 200, 4, 4, d), True, dt),
                  (f"D={d} s_q 128 < s_k 256", (2, 128, 256, 4, 4, d), False,
                   dt)]
    if d in UNET_HEAD_DIMS:
        cases.append((f"D={d} GQA 8:2", (2, 256, 256, 8, 2, d), True,
                      torch.bfloat16))
    return cases


def head_dim_checks(fa, gen, worst=None):
    """Phase 2e for rows 3/5/6: every head dim of ``HEAD_DIMS_2E`` against
    the plain versions under ``TRAIN_TOL`` (and bf16 segment, GQA and
    dropout cases each, causal and not, with the dropout masks read out,
    so that the wgmma bodies run every branch at every width), and the
    dropout (rate 0.1) and segment branches at head
    dims 40 and 160 (SD-1.5's level 0 and 2), bf16 and f32, and bf16
    non-causal at ``UNET_ATTN_SHAPES`` (the shapes
    phase 3h gives the kernels); the worst error of each head dim under
    ``head_keys``."""
    worst = {} if worst is None else worst
    for d in HEAD_DIMS_2E:
        attention_checks(fa, gen, head_dim_cases(d), worst, keys=head_keys(d))
        # the segment branch's wgmma bodies at this width (GQA 4:2, causal
        # at the odd multiples of 8), with a segment inside one tile
        attention_checks(fa, gen, [(f"D={d} segments 64/10/118/128",
                                    (2, 320, 320, 4, 2, d), d % 16 == 8,
                                    torch.bfloat16, [64, 10, 118, 128])],
                         worst, keys=head_keys(d))
        # the wgmma bodies without segments at this width: GQA 8:2 at S 200
        # at rate 0, and the dropout branch (GQA 4:2, lengths off the tile)
        # causal and not, with the forward's, dK/dV's and dQ's masks read
        # out against dropout_keep
        attention_checks(fa, gen, [(f"D={d} GQA 8:2 S=200",
                                    (2, 200, 200, 8, 2, d), d % 16 != 8,
                                    torch.bfloat16)],
                         worst, keys=head_keys(d))
        attention_checks(fa, gen, [(f"D={d} dropout", (2, 200, 200, 4, 2, d),
                                    causal, torch.bfloat16)
                                   for causal in (False, True)],
                         worst, DROPOUT_RATE, head_keys(d))
        for causal in (False, True):
            n, _ = check_masks(fa, (1, 136, 200, 4, 2, d), torch.bfloat16,
                               causal, (d << 32) | 99)
            print(f"  dropout masks read out of o, dq, dk and dv (D={d} GQA "
                  f"4:2 s_q 136 < s_k 200, causal={causal}): {n:,} scores "
                  f"each, every bit equal to dropout_keep")
    for shape in UNET_ATTN_SHAPES:
        attention_checks(fa, gen, [(f"UNet D={shape[-1]}", shape, False,
                                    torch.bfloat16)], worst,
                         keys=head_keys(shape[-1]))
    for d in (40, 160):
        drop = [(f"D={d} dropout", (2, 256, 256, 4, 2, d), True, dt)
                for dt in (torch.bfloat16, torch.float32)]
        attention_checks(fa, gen, drop, worst, DROPOUT_RATE, head_keys(d))
        seg = [(f"D={d} segments", (2, 256, 256, 4, 4, d), causal, dt,
                [100, 156]) for dt in (torch.bfloat16, torch.float32)
               for causal in (False, True)]
        attention_checks(fa, gen, seg, worst, keys=head_keys(d))
    return worst


def ragged_head_cases(d):
    """Rows 1-2 at head dim d: a decode launch long enough to split (so the
    merge runs at d too), a ragged verify mix with GQA 8:2 (the tensor-core
    tile for bf16 q) and a 90-row prefill chunk over a cached prefix."""
    return [
        (f"D={d} decode kv_len 1/100/512/1001 (split)",
         dict(S=4, Qmax=1, Hq=8, Hkv=8, D=d, ps=16, NP=300, P=64,
              q_start=[0, 99, 511, 1000], q_len=[1, 1, 1, 1],
              kv_len=[1, 100, 512, 1001])),
        (f"D={d} verify q_len 0/1/3/5 GQA 8:2",
         dict(S=4, Qmax=5, Hq=8, Hkv=2, D=d, ps=16, NP=40, P=8,
              q_start=[10, 100, 63, 0], q_len=[0, 1, 3, 5],
              kv_len=[10, 101, 66, 5])),
        (f"D={d} chunk of 90 rows over 64 cached",
         dict(S=1, Qmax=96, Hq=8, Hkv=8, D=d, ps=16, NP=16, P=12,
              q_start=[64], q_len=[90], kv_len=[154])),
    ]


def ragged_head_dim_checks(pa):
    """Phase 2e for rows 1-2: ``RAGGED_HEAD_DIMS`` over bf16 and f32 pages
    (f32, bf16 and bf16 -> f32 in and out) and int8 / fp8 pages, against the
    plain version under phase 2's tolerances; returns the worst errors."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    worst = {"plain": 0.0, "quant": 0.0}
    n0 = pa.ragged_paged_attention.combine_launches
    for d in RAGGED_HEAD_DIMS:
        for name, kw in ragged_head_cases(d):
            for dtype, out_dtype in DTYPE_PAIRS:
                args = make_case(gen, dtype=dtype, **kw)
                worst["plain"] = max(worst["plain"], compare(
                    pa, f"{name} [{str(dtype)[6:]}]", args, out_dtype))
                for kv_dtype in KV_DTYPES:
                    qargs, scales = quantize_pages(args, kv_dtype)
                    worst["quant"] = max(worst["quant"], compare(
                        pa, f"{name} [{str(dtype)[6:]}, {kv_dtype}]", qargs,
                        out_dtype, **scales))
    require(pa.ragged_paged_attention.combine_launches > n0,
            "no head-dim case ran a split grid")
    return worst


# -- phase 3h: the SD-1.5 UNet train step ------------------------------------
UNET_CTX_LEN = 77                   # CLIP's text tokens
UNET_LR = 1e-4


def unet_config():
    from paddle_tpu_torch.models.unet import unet_config_sd15
    return unet_config_sd15()


def unet_flop(B, c=None, hw=64, ctx_len=UNET_CTX_LEN):
    """Model FLOP of one UNet train step (forward and backward, no
    recomputation), walking the model as its forward does: 6 per weight
    and use for every convolution (uses: output positions) and Linear
    (uses: tokens; the context's for cross-attention's k and v), and
    12 S_q S_k d heads per attention per image (4 forward, 8 backward).
    Norms, activations, the upsampling and the biases are left out."""
    c = c or unet_config()
    ch, t_dim = c.block_channels, c.block_channels[0] * c.time_embed_mult
    mm = ch[0] * t_dim + t_dim * t_dim          # the time MLP, once an image
    attn = 0

    def conv(cin, cout, k, r):
        return cin * cout * k * k * r * r

    def res(cin, cout, r):
        return (conv(cin, cout, 3, r) + t_dim * cout + conv(cout, cout, 3, r)
                + (conv(cin, cout, 1, r) if cin != cout else 0))

    def block(dim, r):
        n = r * r
        lin = (2 * conv(dim, dim, 1, r) + n * 4 * dim * dim
               + n * 2 * dim * dim + ctx_len * 2 * c.cross_attention_dim * dim
               + n * 12 * dim * dim)            # proj, attn1, attn2, GEGLU
        return lin, 12 * n * n * dim + 12 * n * ctx_len * dim

    r, cur = hw, ch[0]
    mm += conv(c.in_channels, ch[0], 3, r)
    skips = []
    for lvl, cout in enumerate(ch):
        for _ in range(c.layers_per_block):
            mm += res(cur, cout, r)
            cur = cout
            if lvl in c.attn_levels:
                lin, a = block(cout, r)
                mm, attn = mm + lin, attn + a
            skips.append(cur)
        if lvl < len(ch) - 1:
            mm += conv(cur, cur, 3, r // 2)
            r //= 2
    lin, a = block(cur, r)
    mm, attn = mm + 2 * res(cur, cur, r) + lin, attn + a
    for lvl in reversed(range(len(ch))):
        cout = ch[lvl]
        for _ in range(c.layers_per_block):
            mm += res(cur + skips.pop(), cout, r)
            cur = cout
            if lvl in c.attn_levels:
                lin, a = block(cout, r)
                mm, attn = mm + lin, attn + a
        if lvl > 0:
            r *= 2
            mm += conv(cur, cur, 3, r)
    mm += conv(cur, c.out_channels, 3, r)
    return 6.0 * B * mm + B * attn


def make_unet_step(dtype, kernels, seed=0, cfg=None, lr=UNET_LR):
    """bench.py bench_sd_unet's step on the port: the UNet (``cfg``, SD
    1.5's by default) predicts the noise, the loss is the MSE against it in
    f32, and plain SGD at ``lr`` updates every parameter in place.  With
    ``kernels`` both knobs are on (flash attention, the LayerNorm
    kernels); without, both are off.  Returns (step(batch) -> (loss,
    grads), params, n_params)."""
    from paddle_tpu_torch.models.unet import UNet2DConditionModel
    model = UNet2DConditionModel(cfg or unet_config(), dtype=dtype,
                                 device="cuda", seed=seed, kernels=kernels,
                                 norm_kernels=kernels)
    params = dict(model.named_parameters())
    plist = list(params.values())

    def step(batch, marks=None):
        mark = (lambda i: marks[i].record()) if marks else (lambda i: None)
        lat, t, ctx, noise = batch
        mark(0)
        pred = model(lat, t, ctx)
        loss = ((pred.float() - noise.float()) ** 2).mean()
        mark(1)
        grads = torch.autograd.grad(loss, plist)
        mark(2)
        with torch.no_grad():
            torch._foreach_add_(plist, [g.to(p.dtype) for p, g in
                                        zip(plist, grads)], alpha=-lr)
        mark(3)
        return loss.detach(), grads

    return step, params, sum(v.numel() for v in plist)


def unet_batch(B, dtype, seed=0, hw=64, ctx_dim=768):
    """bench_sd_unet's batch: N(0, 1) latents [B, 4, 64, 64], timesteps in
    [0, 1000), a N(0, 1) context [B, 77, 768] and the noise, from ``seed``."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).cuda().to(dtype)
    lat = normal(B, 4, hw, hw)
    t = torch.from_numpy(rng.integers(0, 1000, (B,)).astype(np.int32)).cuda()
    ctx = normal(B, UNET_CTX_LEN, ctx_dim)
    return lat, t, ctx, normal(B, 4, hw, hw)


class CountByHeadDim:
    """Within the block, count rows 3/5/6's launches by head dim: each
    wrapper is swapped in its module (where the op looks it up, as
    PlainAttention swaps them) for one that calls it and reads its
    counts.  A wrapper counts itself through its module name, so the
    counts land on the stand-in and are handed back on exit."""

    NAMES = PlainAttention.NAMES
    COUNTS = ("launches", "dropout_launches", "segment_launches")

    def __enter__(self):
        from paddle_tpu_torch.ops import flash_attention as fa
        self.fa, self.by_d = fa, {}
        self.saved = {n: getattr(fa, n) for n in self.NAMES}
        for key, n in zip(("fa_fwd", "fa_dkv", "fa_dq"), self.NAMES):
            def counted(q, *a, _fn=self.saved[n], _key=key, _n=n, **kw):
                me = getattr(self.fa, _n)
                before = me.launches
                out = _fn(q, *a, **kw)
                k = f"{_key}_d{q.shape[-1]}"
                self.by_d[k] = self.by_d.get(k, 0) + me.launches - before
                return out
            for c in self.COUNTS:
                setattr(counted, c, 0)
            setattr(fa, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            stand_in = getattr(self.fa, n)
            for c in self.COUNTS:
                setattr(fn, c, getattr(fn, c) + getattr(stand_in, c))
            setattr(self.fa, n, fn)


UNET_GROUPS = (("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                         "nchwtonhwc", "nhwctonchw", "implicit")),
               ("fa_fwd", ("fa_fwd_",)),
               ("fa_bwd", ("fa_bwd_dkv_", "fa_bwd_dq_")),
               ("plain attention softmax", ("softmax",)),
               ("groupnorm", ("groupnorm", "group_norm", "rowwisemoments",
                              "computefusedparams", "computeinternalgrad",
                              "computebackwardfusedparams",
                              "gammabetabackward", "groupnorm1d")),
               ("layernorm", ("ln_fwd_kernel", "ln_bwd_vec_kernel",
                              "ln_bwd_kernel", "ln_dwb_reduce_kernel")),
               ("matmul", MATMUL_NAMES))


def unet_attention_plan(c, B, hw):
    """The level of each down and up TransformerBlock, and the levels whose
    self-attention the flash-attention op takes at B x hw x hw latents (all
    three of SD-1.5's at 64 x 64; the middle block's and every
    cross-attention take the plain path)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    blocks = [lvl for lvl in c.attn_levels
              for _ in range(2 * c.layers_per_block)]
    routed = {lvl for lvl in c.attn_levels if fa._supported(
        *[(B, (hw >> lvl) ** 2, c.num_heads,
           c.block_channels[lvl] // c.num_heads)] * 2)}
    return blocks, routed


def phase_unet(pa, B=8, warmup=3, steps=10):
    """Phase 3h: the SD-1.5 UNet train step (``unet_config_sd15``, 4 x 64
    x 64 latents, a 77 x 768 context, t in [0, 1000), bf16 parameters,
    MSE against the noise in f32, SGD at lr 1e-4, as bench_sd_unet steps)
    at batch B: warm-up and timed steps on one batch with the loss of each
    (finite and falling), images/s, the mfu share (``unet_flop`` over 989
    TFLOP/s), peak memory, launches per step (asserted: rows 3/5/6 four
    times at each of head dims 40 / 80 / 160, rows 12/13 at every
    LayerNorm of width 640 and 1,280; the plain attention for the 13
    cross-attentions and the 8 x 8 middle block, and the plain LayerNorm at
    width 320, which the kernels decline as JAX's do; no other plain
    version), the forward / backward / SGD split and one step under
    torch.profiler."""
    c = unet_config()
    torch.cuda.reset_peak_memory_stats()
    step, params, n_params = make_unet_step(torch.bfloat16, True)
    batch = unet_batch(B, torch.bfloat16)
    losses = []
    for _ in range(warmup):
        losses.append(float(step(batch)[0]))
    torch.cuda.synchronize()
    reset_counts(pa)
    with CountPlainCalls() as plain, CountByHeadDim() as by_d:
        t0 = time.perf_counter()
        out = [step(batch)[0] for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in train_wrappers().items()}
    launches.update(branch_counts())
    launches.update(by_d.by_d)
    per_step = {k: n / steps for k, n in launches.items()}
    losses += [float(x) for x in out]
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    hw = batch[0].shape[-1]
    blocks, routed = unet_attention_plan(c, B, hw)
    want = {k: 0 for k in per_step}
    for key in ("fa_fwd", "fa_dkv", "fa_dq"):
        want[key] = sum(lvl in routed for lvl in blocks)
        for lvl in routed:
            want[f"{key}_d{c.block_channels[lvl] // c.num_heads}"] = \
                2 * c.layers_per_block
    wide = [lvl for lvl in blocks if c.block_channels[lvl] % 128 == 0]
    narrow = len(blocks) - len(wide)
    want["ln_fwd"] = want["ln_bwd"] = 3 * (len(wide) + 1)  # + the middle
    require(per_step == want, f"launches per step {per_step} != {want}")
    require(counts(pa) == (0, 0, 0), f"paged attention ran: {counts(pa)}")
    # the cross-attentions, the middle block's and the self-attentions the
    # op declines take the plain path
    plain_want = {"flash_attention_ref": (len(blocks) + 2 + sum(
        lvl not in routed for lvl in blocks)) * steps,
        "layer_norm_ref": 3 * narrow * steps}
    require(plain.calls == plain_want,
            f"plain calls {plain.calls} != {plain_want}")
    from paddle_tpu_torch.ops import flash_attention as fa
    for lvl in sorted(routed):
        d = c.block_channels[lvl] // c.num_heads
        require_bodies(fa, f"the self-attention launches at level {lvl}", d,
                       False, False)
    images_per_s = B * steps / wall
    flop = unet_flop(B, c)
    mfu = flop * steps / wall / BF16_FLOP_PER_S
    peak = torch.cuda.max_memory_allocated()
    print(f"  {n_params:,} parameters in {len(params)} tensors; latents "
          f"{list(batch[0].shape)}, context {list(batch[2].shape)}, bf16; "
          f"self-attention at " + ", ".join(
              f"{(hw >> lvl) ** 2} tokens x head dim "
              f"{c.block_channels[lvl] // c.num_heads}"
              + ("" if lvl in routed else " (plain)")
              for lvl in c.attn_levels)
          + f"; MSE against the noise, SGD lr {UNET_LR}")
    print(f"  model FLOP per step (unet_flop): {flop / 1e12:.3f} T")
    print(f"  loss per step ({warmup} warm-up + {steps} timed): "
          + " ".join(f"{x:.5f}" for x in losses))
    print(f"  {steps} steps in {wall:.3f} s: {wall / steps * 1e3:.1f} ms per "
          f"step, {images_per_s:.2f} images/s, mfu_share {mfu:.4f} "
          f"({flop / 1e12:.2f} TFLOP per step / 989 TFLOP/s)")
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    print(f"  launches per step: {json.dumps(per_step)}; plain calls "
          f"{json.dumps(plain.calls)}")
    breakdown = train_breakdown(step, batch, wall / steps, UNET_GROUPS,
                                stages=("forward", "backward", "sgd"),
                                required=("fa_fwd", "fa_bwd"))
    return dict(launches=launches, images_per_s=images_per_s, mfu=mfu,
                step_ms=wall / steps * 1e3, peak_gib=peak / 2**30,
                losses=losses, n_params=n_params, breakdown=breakdown)


def phase_unet_check(B=1):
    """Phase 4e: one f32 step of the SD-1.5 UNet at full widths (64 x 64
    latents) with both knobs on (rows 3/5/6 at head dims 40 / 80 / 160,
    rows 12/13) and one with both off, from the same seeded weights and
    batch: the loss within 1e-5 relative, every gradient within 1e-4 of
    its tensor's max |grad| (floored at 1e-3 of the step's largest)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    batch = unet_batch(B, torch.float32, seed=1)
    blocks, routed = unet_attention_plan(unet_config(), B,
                                         batch[0].shape[-1])
    runs = []
    for kernels in (False, True):
        step, params, _ = make_unet_step(torch.float32, kernels, seed=2)
        n0 = fa.flash_attention_fwd.launches
        loss, grads = step(batch)
        launched = fa.flash_attention_fwd.launches - n0
        require(launched == (sum(lvl in routed for lvl in blocks)
                             if kernels else 0),
                f"f32 step with kernels={kernels}: {launched} forward "
                f"launches")
        runs.append((float(loss), [g.detach() for g in grads]))
        del step, params, grads
        torch.cuda.empty_cache()
    (l0, g0), (l1, g1) = runs
    g_max = max(g.abs().max().item() for g in g0)
    g_err = max((a - b).abs().max().item()
                / max(b.abs().max().item(), 1e-3 * g_max)
                for a, b in zip(g1, g0))
    print(f"  f32 SD-1.5 UNet step at full width, B={B}, knobs off against "
          f"on: loss {l0:.7f} / {l1:.7f}; grads max |kernel - plain| / max "
          f"|plain| {g_err:.3e} over {len(g0)} tensors (tol 1e-4)")
    require(abs(l1 - l0) <= 1e-5 * abs(l0), "loss differs (rtol 1e-5)")
    require(g_err <= 1e-4, "gradients differ")
    del runs, g0, g1
    torch.cuda.empty_cache()


# -- phase 3j: ResNet-50 and the MobileNets ----------------------------------
# PaddleClas's ResNet50.yaml, first stage: Momentum 0.9 at lr 0.1 with L2
# decay 1e-4, over a global batch of 256
RESNET_LR, RESNET_MOMENTUM, RESNET_DECAY = 0.1, 0.9, 1e-4
# grouped by the ATen ops that launched each kernel (the innermost whose
# name holds a pattern), not by kernel name: cuDNN runs some 1 x 1
# convolutions on the GEMM kernels cuBLAS uses, and its layout transposes
# carry no op's name; the Momentum update is timed in a profiler window of
# its own
RESNET_GROUPS = (("conv", ("convolution",)),
                 ("batch norm", ("batch_norm",)),
                 ("pooling", ("pool",)),
                 ("matmul", ("aten::mm", "aten::addmm", "aten::bmm")))


def vision_macs(model, img):
    """Multiply-adds of one image's forward through ``model`` at ``img``
    px, counted from the shapes its convolutions and Linears see in one
    eval-mode forward of a zero image (hooks; the running buffers do not
    move): out positions x out channels x in channels / groups x kh x kw
    per convolution, in x out per Linear.  BatchNorm, pooling, the
    activations and the biases are left out."""
    from paddle_tpu_torch.nn.layers import Conv2D, Linear
    total = []

    def conv(mod, _, out):
        total.append(out.numel() * mod.weight[0].numel())

    def linear(mod, _, out):
        total.append(out.numel() * mod.weight.shape[0])

    hooks = [m.register_forward_hook(conv if isinstance(m, Conv2D)
                                     else linear)
             for m in model.modules() if isinstance(m, (Conv2D, Linear))]
    was_training = model.training
    model.eval()
    try:
        p = next(model.parameters())
        with torch.no_grad():
            model(torch.zeros(1, 3, img, img, dtype=p.dtype,
                              device=p.device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return sum(total)


def make_vision_step(build, dtype, seed=0, device="cuda"):
    """bench.py bench_resnet50's step on the port, with the BatchNorms in
    training mode: ``build(num_classes=1000)`` (a ResNet or MobileNet),
    cross-entropy through ``log_softmax`` in f32 (f64 for an f64 model),
    and one Momentum(0.9, lr 0.1, L2 decay 1e-4) update of every parameter
    (f32 velocity).  Returns
    (step(batch) -> (loss, grads), model, params); ``step.forward_backward``
    and ``step.update`` are its two halves."""
    from paddle_tpu_torch.optimizer import Momentum
    model = build(num_classes=1000, dtype=dtype, device=device, seed=seed)
    model.train()
    params = dict(model.named_parameters())
    opt = Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                   weight_decay=RESNET_DECAY)
    state = opt.init_opt_state(params, device=device)

    def loss_of(batch):
        x, y = batch
        logits = model(x)
        logp = torch.log_softmax(logits.to(torch.promote_types(
            logits.dtype, torch.float32)), dim=-1)
        return -logp.gather(1, y[:, None]).mean()

    def forward_backward(batch):
        loss = loss_of(batch)
        return loss.detach(), torch.autograd.grad(loss, list(params.values()))

    def update(grads):
        opt.apply_gradients_functional(params, dict(zip(params, grads)),
                                       state)

    def step(batch, marks=None):
        mark = (lambda i: marks[i].record()) if marks else (lambda i: None)
        mark(0)
        loss = loss_of(batch)
        mark(1)
        grads = torch.autograd.grad(loss, list(params.values()))
        mark(2)
        update(grads)
        mark(3)
        return loss.detach(), grads

    step.forward_backward, step.update = forward_backward, update
    return step, model, params


def vision_batch(B, img, dtype, seed=0, device="cuda"):
    """bench_resnet50's batch: N(0, 1) images [B, 3, img, img] and labels
    of 1,000 classes from ``seed``."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (B, 3, img, img)).astype(
        np.float32)).to(device=device, dtype=dtype)
    y = torch.from_numpy(rng.integers(0, 1000, (B,))).to(device)
    return x, y


def vision_breakdown(step, batch, step_s):
    """One unprofiled step's split by CUDA events (forward, backward,
    Momentum), then the forward and backward under torch.profiler, each
    kernel's device ms grouped by ``RESNET_GROUPS`` at the op that
    launched it (:func:`profile_rows`, :func:`group_rows`), and the
    Momentum update in a profiler window of its own.  Device busy is the
    two windows' kernel ms; the ops must claim each kernel once at most.
    Convolution, batch norm and the update must have seen device time."""
    stages = stage_split(step, batch, ("forward", "backward", "momentum"))
    out = {}
    rows, ops, device = profile_rows(
        lambda: out.update(grads=step.forward_backward(batch)[1]))
    unclaimed = ops[-1][1]
    print(f"  the kernels' device time {device:.2f} ms, claimed by ops "
          f"{device - unclaimed:.2f} ms, by no op {unclaimed:.2f} ms")
    require(unclaimed >= -1e-3 * device,
            f"ops claim {device - unclaimed:.2f} of {device:.2f} kernel ms")
    update_rows, _, update = profile_rows(lambda: step.update(out["grads"]))
    groups, named = group_rows(ops, RESNET_GROUPS)
    groups["momentum"] = update
    busy = device + update
    launches = sum(k for _, _, k in rows + update_rows)
    require(groups["conv"] > 0 and groups["batch norm"] > 0
            and groups["momentum"] > 0,
            f"profiler saw no convolution, batch norm or update: {groups}")
    busy_line(busy, step_s, groups, launches)
    for g in groups:
        if g != "momentum":
            print(f"  largest {g} ops: {largest(named, g, 4)}")
    return dict(groups, busy_ms=busy, kernels=launches, **stages)


def no_kernel_ran(pa, plain, what):
    """The train path of a CNN runs none of the port's kernels and no plain
    version: every launch count since ``reset_counts`` is 0."""
    launches = {k: fn.launches for k, fn in train_wrappers().items()}
    launches.update(branch_counts())
    require(not any(launches.values()) and counts(pa) == (0, 0, 0),
            f"{what}: a kernel launched: {launches}, paged {counts(pa)}")
    require(plain.calls == {}, f"{what}: plain calls {plain.calls}")
    return launches


def phase_resnet(pa, card, B=256, img=224, warmup=3, steps=10):
    """Phase 3j: ResNet-50 training at full width and depth (``resnet50``,
    1,000 classes), B x 3 x img x img, bf16 parameters with f32 velocity,
    the BatchNorms in training mode (batch statistics, running buffers
    updated every step, as dygraph ImageNet training runs them), Momentum
    0.9 at lr 0.1 with L2 decay 1e-4 (PaddleClas ResNet50.yaml), the loss
    as bench_resnet50's: warm-up and timed steps on one batch with the
    loss of each (finite and falling), the running buffers moved, no
    kernel of the port launched and no plain version called, images/s,
    the mfu share (6 x ``vision_macs`` per image over 989 TFLOP/s), peak
    memory, and the device ms by group (``vision_breakdown``)."""
    from paddle_tpu_torch.vision.models import resnet50
    torch.cuda.reset_peak_memory_stats()
    step, model, params = make_vision_step(resnet50, torch.bfloat16)
    n_params = sum(v.numel() for v in params.values())
    macs = vision_macs(model, img)
    require(4.0e9 < macs < 4.2e9,
            f"ResNet-50 forward {macs / 1e9:.3f} G multiply-adds, not ~4.1")
    batch = vision_batch(B, img, torch.bfloat16)
    before = {n: b.clone() for n, b in model.named_buffers()}
    losses = [float(step(batch)[0]) for _ in range(warmup)]
    torch.cuda.synchronize()
    reset_counts(pa)
    with CountPlainCalls() as plain:
        t0 = time.perf_counter()
        out = [step(batch)[0] for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = no_kernel_ran(pa, plain, "ResNet-50")
    losses += [float(x) for x in out]
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    still = [n for n, b in model.named_buffers() if torch.equal(b, before[n])]
    require(not still, f"running buffers did not move: {still[:4]}")
    images_per_s = B * steps / wall
    flop = 6.0 * macs * B
    mfu = flop * steps / wall / BF16_FLOP_PER_S
    peak = torch.cuda.max_memory_allocated()
    print(f"  {n_params:,} parameters in {len(params)} tensors, "
          f"{len(before)} running buffers (f32); B={B} x 3 x {img} x {img} "
          f"bf16, NCHW; BatchNorm in training mode; Momentum("
          f"{RESNET_MOMENTUM}, lr {RESNET_LR}, L2 {RESNET_DECAY}), f32 "
          f"velocity")
    print(f"  forward {macs / 1e9:.4f} G multiply-adds per image "
          f"(vision_macs); model FLOP per step {flop / 1e12:.3f} T")
    print(f"  loss per step ({warmup} warm-up + {steps} timed): "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"  running buffers: all {len(before)} moved; kernel launches "
          f"{sum(launches.values())}, plain calls {len(plain.calls)}")
    print(f"  {steps} steps in {wall:.3f} s: {wall / steps * 1e3:.1f} ms per "
          f"step, {images_per_s:.1f} images/s, mfu_share {mfu:.4f} on "
          f"{card}")
    print(f"  peak device memory {peak / 2**30:.2f} GiB on {card}")
    breakdown = vision_breakdown(step, batch, wall / steps)
    print(f"  (the breakdown above on {card})")
    return dict(images_per_s=images_per_s, mfu=mfu, step_ms=wall / steps * 1e3,
                peak_gib=peak / 2**30, losses=losses, n_params=n_params,
                breakdown=breakdown)


def phase_mobilenets(pa, card, B=256, img=224):
    """Phase 3j, second part: MobileNetV1, V2 and V3-Large at full width,
    B x 3 x img x img, bf16, BatchNorm in training mode, the same
    Momentum: two steps each (the second timed alone), both losses finite,
    no kernel of the port launched and no plain version called."""
    from paddle_tpu_torch.vision import models
    out = {}
    for name in ("mobilenet_v1", "mobilenet_v2", "mobilenet_v3_large"):
        step, model, params = make_vision_step(getattr(models, name),
                                               torch.bfloat16)
        macs = vision_macs(model, img)
        batch = vision_batch(B, img, torch.bfloat16)
        reset_counts(pa)
        with CountPlainCalls() as plain:
            first = float(step(batch)[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            second = float(step(batch)[0])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        no_kernel_ran(pa, plain, name)
        require(np.isfinite([first, second]).all(),
                f"{name}: non-finite loss {first}, {second}")
        mfu = 6.0 * macs * B / wall / BF16_FLOP_PER_S
        print(f"  {name}: {sum(v.numel() for v in params.values()):,} "
              f"parameters, {macs / 1e6:.1f} M multiply-adds per image; "
              f"losses {first:.4f} {second:.4f}; second step "
              f"{wall * 1e3:.1f} ms, {B / wall:.1f} images/s, mfu_share "
              f"{mfu:.4f} on {card}")
        out[name] = dict(images_per_s=B / wall, step_ms=wall * 1e3,
                         losses=[first, second], mfu=mfu)
        del step, model, params
        torch.cuda.empty_cache()
    return out


class TF32Off:
    """Within the block, cuDNN and cuBLAS run f32 in f32, not TF32; the
    settings before are restored on exit."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def resnet_step_on(device, dtype, state, batch, train=True):
    """One step of the seeded ResNet-50 (``state``: its state dict) on
    ``device`` in ``dtype``, the BatchNorms in training mode or, with
    ``train=False``, in eval mode: the loss, every gradient, the running
    buffers after the forward, the parameters after the Momentum update
    and before it, all on the host."""
    from paddle_tpu_torch.vision.models import resnet50
    step, model, params = make_vision_step(resnet50, torch.float32,
                                           device=device)
    model.load_state_dict(state)
    model.to(dtype).train(train)
    before = [p.detach().cpu().clone() for p in params.values()]
    x, y = batch
    loss, grads = step((x.to(device=device, dtype=dtype), y.to(device)))
    return (float(loss), [g.detach().cpu() for g in grads],
            [b.detach().cpu() for b in model.buffers()],
            [p.detach().cpu() for p in params.values()], before)


def phase_resnet_check(B=2, img=64):
    """Phase 4f: one step of ResNet-50 at full width and depth, B x 3 x
    img x img, on the card against the same step on the CPU from the same
    seeded weights, buffers and batch, with TF32 off (cuDNN and cuBLAS) for
    the check only.

    With the BatchNorms in eval mode, in f32: the loss to 1e-5 relative,
    every gradient to 1e-4 of its tensor's max |grad|, and every updated
    parameter to 1e-4 of its tensor's largest update plus one f32 ulp of
    its largest entry (both sides round p - lr v once).  With the
    BatchNorms in training mode, in f64: the loss to 1e-5, every gradient
    to 1e-4 of max |grad|, every running buffer to 1e-5 (rtol and atol)
    and every updated parameter to 1e-6 of its tensor's max |p|.  In f32
    this random net's training-mode step is ill-conditioned: the CPU's own
    f32 loss lies about 1e-5 from its f64 one and its f32 gradients 1e-1
    of max |grad| from its f64 ones, so two f32 implementations cannot
    meet those tolerances there.  The card's training-mode f32 step is held
    to the CPU's f64 instead, the loss and the buffers to 1e-4: an f32
    step lands within that, a TF32 one (10 mantissa bits) does not, as the
    same step with TF32 on, printed beside it, shows."""
    from paddle_tpu_torch.vision.models import resnet50
    state = {k: v.clone() for k, v in resnet50(
        num_classes=1000, device="cpu", seed=3).state_dict().items()}
    batch = vision_batch(B, img, torch.float32, seed=4, device="cpu")

    def gaps(run, ref):
        """(loss, buffers, grads, params, updates) of ``run`` against
        ``ref``: the loss relative, the buffers in units of 1e-5 + 1e-5
        |ref|, the grads and params relative to each tensor's max |ref|,
        the params in units of 1e-4 of the tensor's largest update in
        ``ref`` plus one f32 ulp of its largest entry."""
        (l1, g1, b1, p1, _), (l0, g0, b0, p0, q0) = run, ref

        def of_max(a, b):
            return max(((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                       .item() for x, y in zip(a, b))
        return (abs(l1 - l0) / abs(l0),
                max(((x - y).abs() / (1e-5 + 1e-5 * y.abs())).max().item()
                    for x, y in zip(b1, b0)), of_max(g1, g0), of_max(p1, p0),
                max(((x - y).abs().max() / (1e-4 * (y - q).abs().max()
                                            + 2.0**-23 * y.abs().max()))
                    .item() for x, y, q in zip(p1, p0, q0)))

    runs = {}
    with TF32Off():
        print(f"  TF32 off for the check: cuBLAS "
              f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
              f"{torch.backends.cudnn.allow_tf32}")
        for device in ("cpu", "cuda"):
            runs["eval", device] = resnet_step_on(
                device, torch.float32, state, batch, train=False)
        for dtype in (torch.float64, torch.float32):
            for device in ("cpu", "cuda"):
                runs[dtype, device] = resnet_step_on(device, dtype, state,
                                                     batch)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        runs["tf32"] = resnet_step_on("cuda", torch.float32, state, batch)
    ref, card = runs["eval", "cpu"], runs["eval", "cuda"]
    loss, _, grad, _, upd = gaps(card, ref)
    print(f"  f32 ResNet-50 step, B={B} x {img} x {img}, eval-mode "
          f"BatchNorm, card against CPU: loss {card[0]:.9f} / {ref[0]:.9f} "
          f"({loss:.2e}, tol 1e-5); grads max |card - CPU| / max |CPU| "
          f"{grad:.3e} (tol 1e-4); updated params {upd:.3f} x (1e-4 max "
          f"|update| + 1 ulp of max |p|) (tol 1)")
    require(loss <= 1e-5 and grad <= 1e-4 and upd <= 1.0,
            "the card's f32 eval-mode step differs from the CPU's")
    ref, card64 = runs[torch.float64, "cpu"], runs[torch.float64, "cuda"]
    loss, buf, grad, par, _ = gaps(card64, ref)
    print(f"  f64 ResNet-50 step, B={B} x {img} x {img}, training-mode "
          f"BatchNorm, card against CPU: loss {card64[0]:.12f} / "
          f"{ref[0]:.12f} ({loss:.2e}, tol 1e-5); grads max |card "
          f"- CPU| / max |CPU| {grad:.3e} (tol 1e-4); buffers {buf:.2e} x "
          f"(1e-5 + 1e-5 |CPU|) (tol 1); updated params {par:.3e} of max "
          f"|p| (tol 1e-6)")
    require(loss <= 1e-5 and grad <= 1e-4 and buf <= 1.0 and par <= 1e-6,
            "the card's f64 step differs from the CPU's")
    for what, run in (("CPU f32", runs[torch.float32, "cpu"]),
                      ("card f32", runs[torch.float32, "cuda"]),
                      ("card f32 with TF32 on", runs["tf32"])):
        loss, buf, grad, par, _ = gaps(run, ref)
        print(f"  training mode, {what} against the CPU's f64: loss "
              f"{run[0]:.9f} ({loss:.2e}), buffers {buf / 10:.3f} x (1e-4 + "
              f"1e-4 |f64|), grads {grad:.3e} of max |grad|, updated params "
              f"{par:.3e} of max |p|")
        if what == "card f32":
            require(loss <= 1e-4 and buf <= 10.0,
                    "the card's f32 step is not within 1e-4 of f64")
    torch.cuda.empty_cache()


# -- phase 5e: rows 3/5/6 at the UNet's shapes, rows 1-2 at d 80 -------------
L2_BYTES = 50e6                    # H100 SXM


def attention_copies(gen, shape):
    """bf16 (q, k, v, dO) at one attention shape, in as many copies as
    together exceed twice the L2 (at least 2): inputs that timed replays
    take in turn, so that no replay finds them where the one before left
    them."""
    b, s_q, s_k, hq, hkv, d = shape
    set_bytes = 2 * (2 * b * s_q * hq * d + 2 * b * s_k * hkv * d)
    n = max(2, -(-int(2 * L2_BYTES) // set_bytes))
    return [attn_inputs(gen, shape, torch.bfloat16) for _ in range(n)]


def sdpa_graph_times(copies, iters):
    """SDPA, non-causal, on ``copies`` of [B, S, H, D] q, k, v, dO taken in
    turn, each as a CUDA-graph replay (``graph_ms``): the forward, the
    backward alone (``autograd.grad`` on one forward kept per copy, run on
    the capture stream so that its backward is captured) and forward +
    backward, in ms."""
    import torch.nn.functional as F
    n = len(copies)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        plain = [tuple(t.transpose(1, 2) for t in c[:3]) for c in copies]
        leaves = [tuple(t.detach().requires_grad_(True) for t in p)
                  for p in plain]
        dots = [c[3].transpose(1, 2) for c in copies]
        outs = [F.scaled_dot_product_attention(*lv) for lv in leaves]
    fwd = graph_ms(lambda i: F.scaled_dot_product_attention(*plain[i % n]),
                   iters, side)
    bwd = graph_ms(lambda i: torch.autograd.grad(
        outs[i % n], leaves[i % n], dots[i % n], retain_graph=True), iters,
        side)
    both = graph_ms(lambda i: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves[i % n]), leaves[i % n],
        dots[i % n]), iters, side)
    return fwd, bwd, both


def graph_attention_timing(fa, gen, shape, label, iters=10):
    """Rows 3, 5 and 6 at one bf16 non-causal shape, the kernels and SDPA
    (``sdpa_graph_times``) alike as CUDA-graph replays over
    ``attention_copies`` taken in turn: the device's time, with no input
    left in the L2 by the call before (the kernels at 256 tokens take about
    a call's host cost, which an eager timing would measure instead).  The
    plain versions are timed eagerly; the bounds are ``attention_timing``'s."""
    b, s_q, s_k, hq, hkv, d = shape
    copies = attention_copies(gen, shape)
    n = len(copies)
    args = (False, 1.0 / np.sqrt(d), 0.0, 0)
    stats = []
    for q, k, v, do in copies:
        o, lse = fa.flash_attention_fwd(q, k, v, *args)
        stats.append((lse, delta_of(do, o)))
    lib_fwd, lib_bwd, lib_both = sdpa_graph_times(copies, iters)
    q, k, v, do = copies[0]
    lse, delta = stats[0]
    pairs = b * hq * s_q * s_k
    q_bytes, kv_bytes = b * s_q * hq * d * 2, b * s_k * hkv * d * 2
    stats_bytes = b * hq * s_q * 4
    print(f"  {n} input copies of {4 * q_bytes / 1e6:.1f} MB, taken in turn "
          f"by kernels and SDPA alike")
    bwd_what = (f"SDPA non-causal backward alone, graph replay; forward + "
                f"backward {lib_both:.4f} ms")

    def kernel(fn):
        return graph_ms(lambda i: fn(*copies[i % n], *stats[i % n]), iters)
    res = {}
    res["fa_fwd"] = report(
        f"flash_attention_fwd{label}",
        kernel(lambda q, k, v, do, lse, delta: fa.flash_attention_fwd(
            q, k, v, *args)),
        time_ms(lambda i: fa.flash_attention_fwd_ref(q, k, v, *args), 3,
                warmup=1), lib_fwd,
        2 * q_bytes + 2 * kv_bytes + stats_bytes, 4 * d * pairs,
        "SDPA non-causal forward, graph replay")
    res["fa_dkv"] = report(
        f"flash_attention_bwd_dkv{label}",
        kernel(lambda *t: fa.flash_attention_bwd_dkv(*t, *args)),
        time_ms(lambda i: fa.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse, delta, *args), 3, warmup=1), lib_bwd,
        2 * q_bytes + 4 * kv_bytes + 2 * stats_bytes, 8 * d * pairs,
        bwd_what)
    res["fa_dq"] = report(
        f"flash_attention_bwd_dq{label}",
        kernel(lambda *t: fa.flash_attention_bwd_dq(*t, *args)),
        time_ms(lambda i: fa.flash_attention_bwd_dq_ref(
            q, k, v, do, lse, delta, *args), 3, warmup=1), lib_bwd,
        3 * q_bytes + 2 * kv_bytes + 2 * stats_bytes, 6 * d * pairs,
        bwd_what)
    del copies, stats, q, k, v, do, lse, delta
    torch.cuda.empty_cache()
    return res


# Design steps of the wgmma dK/dV and dQ without segments (compile-time
# settings of flash_attention.cu, as ``FA_VARIANTS``; the shipped build
# first) at the shapes where they take the longest: 3c's causal one (W 64),
# the UNet's level 0 (64 q tiles per key block at W 48) and 3d's at dropout
# 0.1 (the mask's Philox rounds against the products; the dropout branch is
# not pipelined, at any setting).  A consumer holds
# two stages of its ring (the tile it scores, and the one whose products
# are in flight), so a ring of 3 loads one tile ahead; without the
# pipelining it holds one.
BWD_VARIANTS = (
    ("shipped: dK/dV 64-row q tiles, a ring of 4; dQ a ring of 4", ()),
    ("dK/dV a ring of 3", ("-DFA_DKV_HP_STAGES=3",)),
    ("dK/dV a ring of 6", ("-DFA_DKV_HP_STAGES=6",)),
    ("dK/dV 32-row q tiles", ("-DFA_DKV_HP_BQ=32",)),
    ("dK/dV not pipelined", ("-DFA_DKV_HP_PIPELINE=0",)),
    ("dQ a ring of 3", ("-DFA_DQ_HP_STAGES=3",)),
    ("dQ a ring of 6", ("-DFA_DQ_HP_STAGES=6",)),
)
# (shape, causal, dropout rate)
BWD_DESIGN_SHAPES = (((8, 2048, 2048, 16, 16, 64), True, 0.0),
                     (UNET_ATTN_SHAPES[0], False, 0.0),
                     (ERNIE_ATTN_SHAPE, False, DROPOUT_RATE))
# dK/dV without segments above two 64-column panels, mma.sync against the
# wgmma body, which decide ``MMA_SYNC_DKV_WIDTHS``: the width whose dK/dV
# keeps mma.sync (``FA_DKV_MMA_SYNC_W``; 0: none) at the UNet's level 2 (W
# 160) and at the two wider widths, which no model of the repo takes, at
# its sequence; each at rate 0 and at dropout 0.1
WIDE_VARIANTS = (
    ("shipped: dK/dV without segments on mma.sync at W 160", ()),
    ("on the wgmma body at every width", ("-DFA_DKV_MMA_SYNC_W=0",)),
    ("on mma.sync at W 192", ("-DFA_DKV_MMA_SYNC_W=192",)),
    ("on mma.sync at W 256", ("-DFA_DKV_MMA_SYNC_W=256",)),
)
WIDE_SHAPES = tuple((shape, False, rate)
                    for shape in (UNET_ATTN_SHAPES[2], (8, 256, 256, 8, 8, 192),
                                  (8, 256, 256, 8, 8, 256))
                    for rate in (0.0, DROPOUT_RATE))


def backward_design_steps(fa, gen, variants, shapes):
    """One line per entry of ``variants`` (BWD_VARIANTS, WIDE_VARIANTS) at
    each (shape, causal, dropout rate) of ``shapes``, in two turns: the
    variant's dK/dV and dQ held against the plain versions, then timed as
    CUDA-graph replays over ``attention_copies``, with ptxas's registers
    and spills of the two wgmma instantiations at that rate.  A
    measurement only: the port loads the shipped build, which is put back
    however this ends."""
    import ctypes

    from paddle_tpu_torch.ops import _build
    names = [_build.width_library("flash_attention",
                                  fa.head_width(shape[-1]))
             for shape, _, _ in shapes]
    t0 = time.perf_counter()
    paths = build_variants(variants, names)
    print(f"  built {len(variants)} variants of {sorted(set(names))} in "
          f"{time.perf_counter() - t0:.1f} s")
    tol = TRAIN_TOL[torch.bfloat16]
    for (shape, causal, rate), name in zip(shapes, names):
        d = shape[-1]
        w = fa.head_width(d)
        args = (causal, 1.0 / np.sqrt(d), rate, 777 if rate > 0 else 0)
        copies = attention_copies(gen, shape)
        n = len(copies)
        q, k, v, do = copies[0]
        _, rlse = fa.flash_attention_fwd_ref(q, k, v, *args)
        o, _ = fa.flash_attention_fwd(q, k, v, *args)
        delta = delta_of(do, o)
        want = (*fa.flash_attention_bwd_dkv_ref(q, k, v, do, rlse, delta,
                                                *args),
                fa.flash_attention_bwd_dq_ref(q, k, v, do, rlse, delta,
                                              *args))
        stats = [(rlse, delta)]
        for c in copies[1:]:
            o, lse = fa.flash_attention_fwd(*c[:3], *args)
            stats.append((lse, delta_of(c[3], o)))
        shipped = _build.library(name)
        tag = f"{list(shape)} causal={causal} rate {rate:g}"
        try:
            for turn in (1, 2):
                for (what, _), path in zip(variants, paths):
                    _build._LIBS[name] = ctypes.CDLL(str(path[name]))
                    if turn == 1:
                        got = (*fa.flash_attention_bwd_dkv(
                            q, k, v, do, rlse, delta, *args),
                            fa.flash_attention_bwd_dq(q, k, v, do, rlse,
                                                      delta, *args))
                        for x, g, r in zip(("dk", "dv", "dq"), got, want):
                            held(f"{x} [{what}] {tag}", g, r, tol)
                        del got
                    dkv_ms = graph_ms(lambda i: fa.flash_attention_bwd_dkv(
                        *copies[i % n], *stats[i % n], *args), 10)
                    dq_ms = graph_ms(lambda i: fa.flash_attention_bwd_dq(
                        *copies[i % n], *stats[i % n], *args), 10)
                    bodies = (fa.kernel_body("bwd_dkv", torch.bfloat16, d,
                                             False, rate > 0),
                              fa.kernel_body("bwd_dq", torch.bfloat16, d,
                                             False, rate > 0))
                    regs = ", ".join(
                        f"{'dK/dV' if 'dkv' in kern else 'dQ'} {r} "
                        f"registers, {st} B spilled"
                        for kern, a, r, st, _ in ptxas_lines(path[name])
                        if kern in ("fa_bwd_dkv_wgmma_kernel",
                                    "fa_bwd_dq_wgmma_kernel")
                        and template_args(a) == [w, 0, int(rate > 0)])
                    print(f"  design step of the wgmma backward, turn "
                          f"{turn}, {what}, {tag}: dK/dV {dkv_ms:.4f} ms "
                          f"({bodies[0]}), dQ {dq_ms:.4f} ms ({bodies[1]}) "
                          f"({regs})")
        finally:
            _build._LIBS[name] = shipped
        del copies, stats, q, k, v, do, o, rlse, delta, want
        torch.cuda.empty_cache()


def phase_unet_timing(pa, decode_kv_lens, parent=None):
    """Phase 5e: rows 3/5/6 at the three UNet shapes (non-causal,
    ``graph_attention_timing``), each beside its bound (counted at the head
    dim, not the padded width), the plain version's time and SDPA's forward
    and backward at the same shape, and with ``parent`` (another commit's
    ``csrc``) that build's rows in turns with these; the design steps of
    the wgmma dK/dV and dQ (``BWD_VARIANTS``); then rows 1-2 at head dim 80
    at phase 3a's decode shape (32 heads, pages of 16) beside their byte
    bound.  Returns the timings by the UNet rows' keys."""
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(23)
    res = {}
    for shape in UNET_ATTN_SHAPES:
        d = shape[-1]
        print(f"  {list(shape)} (S {shape[1]}, head dim {d} at width "
              f"{fa.head_width(d)}), non-causal:")
        t = graph_attention_timing(fa, gen, shape, f" (d {d})")
        res.update({f"{k}_d{d}": v for k, v in t.items()})
        if parent is not None:
            print(f"  rows 3/5/6 at head dim {d} against the build of "
                  f"{parent}, in turns:")
            parent_attention_turns(parent, fa, gen, shape, False)
    if parent is not None:
        print(f"  phase 3h's train step on the flash-attention libraries of "
              f"{parent} and on these, in turns:")
        parent_step_turns(parent, fa, "3h")
    print("  design steps of the wgmma dK/dV and dQ without segments:")
    backward_design_steps(fa, gen, BWD_VARIANTS, BWD_DESIGN_SHAPES)
    (nopipe,) = build_variants([v for v in BWD_VARIANTS
                                if v[1] == ("-DFA_DKV_HP_PIPELINE=0",)])
    print("  the SASS that dropout adds to the wgmma dK/dV, against its "
          "twin in the build whose dK/dV does not pipeline (as its "
          "dropout branch never does):")
    philox_sass_report(nopipe["flash_attention"],
                       ("fa_bwd_dkv_wgmma_kernel",))
    print("  dK/dV above W 128, mma.sync against the wgmma body:")
    backward_design_steps(fa, gen, WIDE_VARIANTS, WIDE_SHAPES)
    sh = shapes(decode_kv_lens)[0]
    for kv_dtype in (None, "int8"):
        time_shape(pa, gen, sh, kv_dtype, D=80)
    return res


UNET_ROWS = [
    dict(key=f"{k}_d{d}", name=f"{n} (head dim {d})", route="cuda",
         source=CSRC + "flash_attention.cu",
         replaces=f"paddle_tpu/ops/pallas/flash_attention.py:{line}")
    for d in UNET_HEAD_DIMS
    for k, n, line in (("fa_fwd", "flash_attention_fwd", 64),
                       ("fa_dkv", "flash_attention_bwd_dkv", 268),
                       ("fa_dq", "flash_attention_bwd_dq", 347))]


def parent_engine_turn(root):
    """Phases 3a and 3b of another commit, from its checkout at ``root``, in
    a process of their own (it imports that commit's ``paddle_tpu_torch``
    and ``chip_smoke``): its ragged paged-attention libraries built from its
    sources, then its ``phase_serving`` and ``phase_serving_quant`` on the
    same seeded weights.  Prints its output."""
    code = "\n".join((
        "import torch, chip_smoke as c",
        "from paddle_tpu_torch.ops import _build, paged_attention as pa",
        "from paddle_tpu_torch.models.llama import (init_llama_params,",
        "                                           llama_config_7b)",
        "torch.backends.cuda.matmul.allow_tf32 = False",
        "_build.build_all(['ragged_paged_attention',",
        "                  'ragged_paged_attention_quant'])",
        "cfg = llama_config_7b()",
        "p = init_llama_params(cfg, dtype=torch.bfloat16, device='cuda',",
        "                      seed=0)",
        "s = c.phase_serving(pa, cfg, p)",
        "c.phase_serving_quant(pa, cfg, p, s['kv_bytes'])"))
    root = os.path.abspath(root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=900)
    for line in res.stdout.splitlines():
        print(f"  [parent] {line}")
    require(res.returncode == 0,
            f"the parent's serving phases failed: {res.stderr[-3000:]}")


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="csrc directory of another commit: phase 1 "
                         "builds its flash-attention libraries, phase 5 "
                         "times its ragged paged attention and softmax "
                         "forward, phase 5b its flash-attention kernels, "
                         "the 3c and 3d steps on them, RMSNorm forward and "
                         "LayerNorm backward, 5d its segment kernels and 5e "
                         "its kernels at the UNet's head dims and the 3h "
                         "step on them, in turns with these")
    ap.add_argument("--parent-engine", metavar="ROOT", default=None,
                    help="checkout of another commit: its phases 3a and 3b "
                         "run in a process of their own before this "
                         "commit's and again after phase 3k")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible")
    from paddle_tpu_torch.models.llama import (init_llama_params,
                                               llama_config_7b)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused as fu
    from paddle_tpu_torch.ops import paged_attention as pa

    t_start = time.perf_counter()

    def say(header):
        print(f"{header} [{time.perf_counter() - t_start:.0f} s]",
              flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {card}")

    say("phase 1: build")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
          f"(one nvcc per source, all started together); seconds to each: "
          + ", ".join(f"{n} {s:.1f}" for n, s in sorted(
              _build.BUILD_SECONDS.items(), key=lambda x: x[1])))
    register_report(built, args.parent)

    say("phase 2: kernels vs plain version on the card")
    max_err = phase_kernel(pa)
    say("phase 2b: train kernels vs plain version on the card")
    max_err.update(phase_train_kernels(fa, fu))
    say("phase 2c: LayerNorm, softmax and AdamW kernels, flash attention "
          "at ERNIE's shape, and its dropout branch, vs plain version on the "
          "card; the dropout mask read out of the kernel")
    phase_fused_kernels(fa, fu, max_err)
    say("phase 2d: the segment branch of flash attention (varlen, and the "
          "padding of untileable sequences) vs plain version on the card")
    phase_segment_kernels(fa, max_err)
    say("phase 2e: flash attention at every head width and ragged paged "
          "attention at head dims 40 / 80 / 96 / 256 vs plain version on the "
          "card")
    head_dim_checks(fa, torch.Generator(device="cuda").manual_seed(29),
                    max_err)
    ragged_head_dim_checks(pa)

    if args.parent_engine:
        say("phase 3a/3b of the parent commit (turn 1 of 2)")
        torch.cuda.empty_cache()
        parent_engine_turn(args.parent_engine)
    say("phase 3a: serving at LLaMA-2 7B widths (bf16 KV, 32 layers; decode "
        "horizons as CUDA graphs)")
    cfg = llama_config_7b()
    t0 = time.perf_counter()
    params = init_llama_params(cfg, dtype=torch.bfloat16, device="cuda",
                               seed=0)
    torch.cuda.synchronize()
    print(f"  random weights on the card in {time.perf_counter() - t0:.1f} s")
    model_function_checks(cfg, params)
    serve = phase_serving(pa, cfg, params)
    say("phase 3a': the same traffic with overlap=True (the double-buffered "
        "host loop)")
    serve_o = phase_serving(pa, cfg, params, overlap=True,
                            want=serve["streams"])
    say("phase 3a'': 3a's traffic through both engines in turns (sync, "
        "overlap, overlap, sync)")
    turns = serving_turns(cfg, serve, serve_o)
    del serve["engine"], serve_o["engine"]
    say("phase 3b: serving at LLaMA-2 7B widths (int8 KV, speculative=4, "
          "32 layers)")
    serve_q = phase_serving_quant(pa, cfg, params, serve["kv_bytes"])
    say("phase 3i: the request lifecycle at LLaMA-2 7B widths (snapshot / "
        "restore, export_kv / import_kv, cancel and timeout with a dispatch "
        "in flight; two overlap=True engines sharing the weights)")
    phase_lifecycle(cfg, params, serve_q["succ"])
    say("phase 3k: the serving engine's telemetry, fault points and durable "
        "snapshots at LLaMA-2 7B widths (telemetry on against off, fault "
        "drills, crash-consistent snapshots, the profiler bridge)")
    obs = phase_telemetry(pa, cfg, params, serve_q["succ"], card)
    del params
    torch.cuda.empty_cache()
    if args.parent_engine:
        say("phase 3a/3b of the parent commit (turn 2 of 2)")
        parent_engine_turn(args.parent_engine)
    say("phase 3c: train step of the 271M LLaMA (bf16, B=8, S=2048, "
          "16 layers)")
    train = phase_train(pa)
    torch.cuda.empty_cache()
    say(f"phase 3d: ERNIE-3.0-base MLM train step (bf16, B=64, S=512, "
          f"12 layers, dropout {DROPOUT_RATE})")
    ernie = phase_ernie(pa)
    torch.cuda.empty_cache()
    say("phase 3d, the same step at dropout 0 (the cost of dropout on this "
          "card)")
    ernie0 = phase_ernie(pa, warmup=2, steps=5, dropout=0.0)
    torch.cuda.empty_cache()
    say(f"phase 3f: ERNIE-3.0-base sequence classification fine-tuning "
          f"step (2 classes, bf16, B=32, S=128, dropout {DROPOUT_RATE}, "
          f"AdamW lr 2e-5)")
    cls = phase_ernie(pa, B=32, S=128, warmup=2, steps=10, classes=2,
                      lr=2e-5)
    torch.cuda.empty_cache()
    say("phase 3e: nn.functional.softmax through the softmax kernels")
    softmax_launches = phase_softmax_entry()
    say("phase 3g: ViT-L/16 train step at 384 px (bf16, B=32, 577 tokens, "
          "24 layers)")
    vit = phase_vit(pa)
    torch.cuda.empty_cache()
    say("phase 3g': ViT-L/16 train step at 224 px (bf16, B=64, 197 "
          "tokens), as bench.py's bench_vit_l16 runs it")
    vit224 = phase_vit(pa, img=224, B=64, warmup=2, steps=3)
    torch.cuda.empty_cache()
    say("phase 3h: SD-1.5 UNet train step (bf16, B=8, 64 x 64 latents, "
          "77-token context, SGD lr 1e-4)")
    unet = phase_unet(pa)
    torch.cuda.empty_cache()
    say("phase 3j: ResNet-50 train step (bf16, B=256, 224 x 224, "
        "BatchNorm in training mode, Momentum 0.9, lr 0.1, L2 1e-4)")
    resnet = phase_resnet(pa, card)
    torch.cuda.empty_cache()
    say("phase 3j': MobileNet V1 / V2 / V3-Large, two steps each (bf16, "
        "B=256, 224 x 224, BatchNorm in training mode, the same Momentum)")
    mobilenets = phase_mobilenets(pa, card)

    say("phase 4: engine checks, kernels vs plain version")
    phase_engine(pa, cfg)
    say("phase 4b: train step, kernels vs plain versions")
    phase_train_check()
    say("phase 4c: ERNIE train step, kernels vs plain versions, at "
          "dropout 0 and 0.1")
    phase_ernie_check()
    torch.cuda.empty_cache()
    say("phase 4d: ViT-L/16 train step at 384 px, kernels vs plain "
          "versions")
    phase_vit_check()
    say("phase 4e: SD-1.5 UNet train step (f32, B=1), kernels vs plain "
          "versions")
    phase_unet_check()
    say("phase 4f: ResNet-50 step (B=2, 64 x 64), card against CPU: "
        "eval-mode BatchNorm in f32, training mode in f64 and f32, TF32 "
        "off")
    phase_resnet_check()

    say("phase 5: kernel timing at the phase-3 shapes")
    timing = phase_timing(pa, cfg.num_hidden_layers,
                          serve["decode_kv_lens"], serve_q["decode_kv_lens"],
                          parent=args.parent)
    say("phase 5b: train kernel timing at the phase-3c shapes")
    timing.update(phase_train_timing(parent=args.parent))
    say("phase 5c: LayerNorm, softmax and AdamW timing at the phase-3d/3e "
          "shapes")
    timing.update(phase_fused_timing())
    say("phase 5d: the segment branch of flash attention at the phase-3g "
          "shape and at a packed varlen shape")
    timing.update(phase_segment_timing(args.parent))
    say("phase 5e: flash attention at the SD-1.5 UNet's shapes (head dims "
          "40 / 80 / 160) and ragged paged attention at head dim 80")
    timing.update(phase_unet_timing(pa, serve["decode_kv_lens"],
                                    args.parent))

    say("phase 6: summary")
    for name, sv, what in (("bf16 KV", serve, "decode"),
                           ("bf16 KV, overlap=True", serve_o, "decode"),
                           ("int8 KV + speculative=4", serve_q, "verify")):
        st = sv["step"]
        print(f"  serving, {name}: {sv['tokens_per_s']:.1f} tokens/s, TTFT "
              f"p50 {sv['ttft_p50_ms']:.1f} ms, p95 {sv['ttft_p95_ms']:.1f} "
              f"ms; {what} step wall {st['wall_ms']:.2f} ms, device "
              f"{st['device_ms']:.2f} ms (busy {st['busy']:.1%}), "
              f"{st['host_launches']:.2f} host launch calls per step on "
              f"{card}")
    for overlap, ts in turns.items():
        print(f"  serving, bf16 KV, overlap={overlap}, in turns: "
              + ", ".join(f"{t:.1f}" for t, _, _ in ts) + " tokens/s")
    print(f"  draft acceptance {serve_q['acceptance']:.3f}")
    for overlap in (False, True):
        o = obs[overlap]
        print(f"  telemetry, overlap={overlap}: tokens/s off "
              + " / ".join(f"{t:.1f}" for t in o["tps"]["off"]) + ", on "
              + " / ".join(f"{t:.1f}" for t in o["tps"]["on"])
              + f"; TTFT p50 {o['ttft_p50_ms']:.1f} / p95 "
              f"{o['ttft_p95_ms']:.1f} ms, TPOT p50 {o['tpot_p50_ms']:.2f} "
              f"ms; synchronising calls {o['syncs']} on {card}")
    print(f"  engine snapshot: {obs['snap']['pages']} pages, "
          f"{obs['snap']['snapshot_bytes'] / 2**20:.1f} MiB, save "
          f"{obs['snap']['save_s']:.3f} s, restore "
          f"{obs['snap']['restore_s']:.3f} s on {card}")
    print(f"  train step: {train['tokens_per_s']:.1f} tokens/s, mfu_share "
          f"{train['mfu']:.4f}, {train['step_ms']:.1f} ms per step, loss "
          f"{train['losses'][0]:.4f} -> {train['losses'][-1]:.4f}, peak "
          f"{train['peak_gib']:.2f} GiB on {card}")
    for what, er in ((f"ERNIE-base MLM step, dropout {DROPOUT_RATE}", ernie),
                     ("ERNIE-base MLM step, dropout 0", ernie0),
                     ("ERNIE-base 2-class fine-tuning step, B 32 x S 128",
                      cls)):
        print(f"  {what}: {er['tokens_per_s']:.1f} tokens/s, mfu_share "
              f"{er['mfu']:.4f}, {er['step_ms']:.1f} ms per step, loss "
              f"{er['losses'][0]:.4f} -> {er['losses'][-1]:.4f}, peak "
              f"{er['peak_gib']:.2f} GiB on {card}")
    for what, v in (("ViT-L/16 at 384 px, B 32", vit),
                    ("ViT-L/16 at 224 px, B 64", vit224),
                    ("SD-1.5 UNet at 64 x 64 latents, B 8", unet)):
        print(f"  {what}: {v['images_per_s']:.1f} images/s, mfu_share "
              f"{v['mfu']:.4f}, {v['step_ms']:.1f} ms per step, loss "
              f"{v['losses'][0]:.4f} -> {v['losses'][-1]:.4f}, peak "
              f"{v['peak_gib']:.2f} GiB on {card}")
    print(f"  ResNet-50 at 224 x 224, B 256, training-mode BatchNorm, "
          f"Momentum: {resnet['images_per_s']:.1f} images/s, mfu_share "
          f"{resnet['mfu']:.4f}, {resnet['step_ms']:.1f} ms per step, loss "
          f"{resnet['losses'][0]:.4f} -> {resnet['losses'][-1]:.4f}, peak "
          f"{resnet['peak_gib']:.2f} GiB on {card}")
    for name, mb in mobilenets.items():
        print(f"  {name} at 224 x 224, B 256: {mb['images_per_s']:.1f} "
              f"images/s, mfu_share {mb['mfu']:.4f} (second step) on {card}")
    cost = ernie["step_ms"] - ernie0["step_ms"]
    print(f"  dropout {DROPOUT_RATE} costs {cost:.1f} ms per MLM step "
          f"({cost / ernie0['step_ms']:+.1%})")
    print(f"  total wall time {time.perf_counter() - t_start:.1f} s")
    rows = []
    for meta, key, launches in ((PLAIN, "plain",
                                 serve["launches"] + serve_o["launches"]),
                                (QUANT, "quant", serve_q["quant_launches"])):
        dec = timing[key]["decode"]
        rows.append(dict(meta, launches=launches, max_abs_err=max_err[key],
                         ms=dec["ms"], plain_ms=dec["plain_ms"],
                         bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
                         library_ms=None))
    rows.append(dict(COMBINE, launches=serve["combines"]
                     + serve_o["combines"] + serve_q["combines"],
                     max_abs_err=max_err["combine"], **timing["combine"]))
    for meta in TRAIN_ROWS:
        key = meta["key"]
        rows.append(dict({k: v for k, v in meta.items() if k != "key"},
                         launches=train["launches"][key],
                         max_abs_err=max_err[key], **timing[key]))
    for meta in DROP_ROWS:
        key = meta["key"]
        rows.append(dict({k: v for k, v in meta.items() if k != "key"},
                         launches=ernie["launches"][key],
                         max_abs_err=max_err[key], **timing[key]))
    for meta in SEG_ROWS:
        key = meta["key"]
        rows.append(dict({k: v for k, v in meta.items() if k != "key"},
                         launches=vit["launches"][key],
                         max_abs_err=max_err[key], **timing[key]))
    for meta in UNET_ROWS:
        key = meta["key"]
        rows.append(dict({k: v for k, v in meta.items() if k != "key"},
                         launches=unet["launches"][key],
                         max_abs_err=max_err[key], **timing[key]))
    for meta in FUSED_ROWS:
        key = meta["key"]
        launches = softmax_launches[key] if key.startswith("softmax") \
            else ernie["launches"][key]
        rows.append(dict({k: v for k, v in meta.items() if k != "key"},
                         launches=launches, max_abs_err=max_err[key],
                         **timing[key]))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
