"""Tensor-parallel CTC beam search: the candidate grid sharded by vocab
over the mesh's 'model' axis, batch (`ctc_beam_search_tp`) and streaming
(`streaming_step_tp`). A port of `gasr_tpu/parallel/decode_tp.py`.

Shard s of n owns vocab ids [s*V // n, (s+1)*V // n). Each frame
every shard scores its slice's extends (and stays, see below), takes its
local top-W, the shards exchange their winners, and every shard reduces
them to the global top-W: the beam state stays replicated. Every
candidate lives on exactly one shard and the global top-W lie in the
union of the local top-Ws, so the result is bit-equal to the
single-device matched-merge decoder (same hashes, same tie order:
score descending in the total order of float bits, then global candidate
index w*V + v ascending).

Three implementations (`tp_impl`), as in JAX:
  * "fused": the whole-scan kernel (`ops/cuda/fused_decode.py::tp_scan`,
    `csrc/decode_tp.cu`): all T frames of every shard in one launch per
    card, the beam state in shared memory, the per-frame exchange of the
    shards' sorted top-W key lists inside the kernel (`csrc/exchange.cuh`:
    through distributed shared memory in a thread-block cluster where the
    group sits on one card, pushed into the peers' inboxes otherwise).
    V <= 256. At n == 1 no exchange code runs.
  * "fused_frame": the frame kernel (`tp_frames`): one launch a card a
    frame, each block merging the previous frame's lists before it runs
    its shard's frame, then one closing merge; nothing else in the loop.
    Any V with ceil(V/n) <= 128.
  * "xla": the plain version of the whole slice (`tp_frames_plain`):
    `tp_frame_merged_plain` per shard and frame, the same merge, the plain
    traceback. JAX's
    "xla" shard step offers the stays on shard 0 and ranks them after the
    shard's extends (an exact tie at the W-th local place can then drop
    one, ROADMAP Queue 3); here, as in the kernels, they sit in the blank
    column of the shard that owns the blank and every candidate ranks by
    its global index.
"auto": n == 1 takes the single-device `ctc_beam_search` /
`streaming_step`; n > 1 takes "fused_frame" on CUDA tensors where it is
eligible (JAX's on-hardware choice, `decode_tp.py:406-416`) and "xla"
otherwise. On CPU tensors the kernels' wrappers run their plain versions.

Meshes: the group is the mesh's first row along `axis` (`mesh.model_row`);
the inputs are replicated, so every data row of a {"data": d, "model": n}
mesh would compute the same decode, and the port runs one. A mesh may
hold one device n times (`parallel/mesh.py`): its n shards then run on
that device through the same code and exchange.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gasr_tpu_torch.decoder import beam_search as _bs
from gasr_tpu_torch.decoder.beam_search import (
    BeamSearchResult, StreamingState, _BeamState, _init_beam, _result,
    ctc_beam_search, streaming_step)
from gasr_tpu_torch.ops.cuda import fused_decode as _fd
from gasr_tpu_torch.parallel.mesh import Mesh, model_row

TP_IMPLS = ("auto", "fused", "fused_frame", "xla")


def _scan(impl: str, log_probs: torch.Tensor, init: torch.Tensor,
          devices, blank_id: int) -> Tuple[_BeamState, torch.Tensor]:
    """The vocab-sharded scan of `impl` from the packed beam `init`:
    (final beam, packed ys [T, B, W]) on the first shard's device."""
    if impl == "fused":
        fins, ys = _fd.tp_scan(log_probs, init, devices, blank_id)
        return _fd.unpack_state(fins[0]), ys
    if impl == "fused_frame":
        fin, ys = _fd.tp_frames(log_probs, init, devices, blank_id)
    else:
        fin, ys = _fd.tp_frames_plain(log_probs.to(devices[0]), init,
                                      len(devices), blank_id)
    return _fd.unpack_state(fin), ys


def _select(tp_impl: str, W: int, V: int, n: int, device: torch.device,
            streaming: bool) -> str:
    """JAX's envelope errors and "auto" dispatch (`decode_tp.py:391-416`,
    `:512-527`); "single" is the single-device decoder."""
    if tp_impl not in TP_IMPLS:
        raise ValueError(f"unknown tp_impl {tp_impl!r}; one of {TP_IMPLS}")
    frame_ok = _fd.tp_envelope(W, V, n, scan=False)
    scan_ok = _fd.tp_envelope(W, V, n, scan=True)
    if tp_impl == "fused" and not scan_ok:
        raise ValueError(
            f"tp_impl='fused' requires W <= 128, n <= V, ceil(V/n) <= "
            f"128, V <= 256; got W={W}, V={V}, n={n}"
            + ("" if streaming else
               " (use 'fused_frame' for larger vocabularies)"))
    if tp_impl == "fused_frame" and not frame_ok:
        raise ValueError(
            f"tp_impl='fused_frame' requires W <= 128, n <= V, "
            f"ceil(V/n) <= 128; got W={W}, V={V}, n={n}")
    if tp_impl == "auto":
        if n == 1:
            return "single"
        return "fused_frame" if device.type == "cuda" and frame_ok \
            else "xla"
    return tp_impl


def ctc_beam_search_tp(
    log_probs: torch.Tensor,
    beam_width: int,
    mesh: Mesh,
    blank_id: int = 0,
    max_len: int = 256,
    axis: str = "model",
    tp_impl: str = "auto",
) -> BeamSearchResult:
    """Model-axis tensor-parallel prefix beam search (log domain).

    log_probs [T, B, V] float32, replicated onto the group's devices;
    results (on the first shard's device) are bit-identical to
    `ctc_beam_search(algorithm='prefix', merge_impl='matched')`. tp_impl:
    see the module docstring; "fused" requires W <= 128, n <= V,
    ceil(V/n) <= 128, V <= 256, "fused_frame" all but V <= 256."""
    if log_probs.ndim != 3 or log_probs.dtype != torch.float32:
        raise ValueError("log_probs must be float32 [T, B, V]")
    T, B, V = log_probs.shape
    W, L = beam_width, max_len
    devices = model_row(mesh, axis)
    n = len(devices)
    impl = _select(tp_impl, W, V, n, devices[0], streaming=False)
    if impl == "single":
        return ctc_beam_search(log_probs, beam_width=W, blank_id=blank_id,
                               max_len=L, algorithm="prefix")
    init = _fd.pack_state(_init_beam(B, W, devices[0]))
    final, packed_ys = _scan(impl, log_probs, init, devices, blank_id)
    tb = _bs._traceback if impl == "xla" else _fd.traceback
    tokens, timesteps, _ = tb(packed_ys, final.length, L)
    return _result(final, tokens, timesteps, L, "prefix")


def streaming_step_tp(
    state: StreamingState,
    chunk_log_probs: torch.Tensor,          # [Tc, B, V] replicated
    mesh: Mesh,
    blank_id: int = 0,
    axis: str = "model",
    tp_impl: str = "auto",
) -> Tuple[StreamingState, BeamSearchResult]:
    """Tensor-parallel streaming decode: advance by one chunk on the
    model-axis vocab-sharded decoder. The carried `StreamingState` is the
    single-device decoder's; each chunk runs the same per-shard machinery
    as `ctc_beam_search_tp` (same `tp_impl` and dispatch rules), and the
    prefixes materialize through the chunk's traceback with the base
    overlay (the `traceback_overlay` kernel for "fused" and
    "fused_frame"). Results are array-equal to the TP batch decode and to
    single-device streaming."""
    if chunk_log_probs.ndim != 3 or chunk_log_probs.dtype != torch.float32:
        raise ValueError("chunk_log_probs must be float32 [Tc, B, V]")
    Tc, B, V = chunk_log_probs.shape
    W = state.beam.s1.shape[1]
    L = state.tokens.shape[2]
    devices = model_row(mesh, axis)
    n = len(devices)
    impl = _select(tp_impl, W, V, n, devices[0], streaming=True)
    if impl == "single":
        return streaming_step(state, chunk_log_probs, blank_id=blank_id)
    dev0 = devices[0]
    base_tok, base_ts = state.tokens.to(dev0), state.timesteps.to(dev0)
    final, packed_ys = _scan(impl, chunk_log_probs,
                             _fd.pack_state(state.beam).to(dev0), devices,
                             blank_id)
    if impl == "xla":
        tokens, timesteps, _ = _bs._traceback(
            packed_ys, final.length, L, base_tokens=base_tok,
            base_timesteps=base_ts, t_offset=state.frames)
    else:
        tokens, timesteps, _ = _fd.traceback_overlay(
            packed_ys, final.length, base_tok, base_ts, state.frames)
    new_state = StreamingState(beam=final, tokens=tokens,
                               timesteps=timesteps,
                               frames=state.frames + Tc)
    return new_state, _result(final, tokens, timesteps, L, "prefix")
