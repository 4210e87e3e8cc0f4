"""Batched serving driver: prefill + greedy decode with KV/state caches
(the port of ``repro.launch.serve``).

The prefill runs the attention, RG-LRU and SSD layers through the
hand-written kernels B5, B7 and B6 on the card (``use_kernels=True``,
the default); decode is plain torch, as in the reference.  Served tokens are
offloaded to a StreamContext consumer that appends to the port's Clovis
(container ``servelog``, object ``stream/tokens``: int32, one row of
``batch`` tokens per step).  Each ``generate`` call is a ``serve.generate``
unit of ``repro_torch.trace`` (attributes ``batch``, ``prompt_len``,
``gen``): its spans are ``serve.prefill`` and, for each decode step,
``serve.decode.issue`` (``decode_step`` and the argmax enqueued, or
their graph replayed), ``serve.decode.wait`` (the host blocked reading
the step's token; the last step's token is never read, and its wait is
the final sync) and ``serve.decode.log`` (the token's push to the
stream); its counts are ``serve.decode_steps`` and
``serve.decode_tokens_returned`` (a row's tokens of decode steps that
the call returns: the last step's is not).
The stats ``prefill_s`` and ``decode_s`` are those spans' host seconds.

On the card, a stack of SSD blocks alone (mamba2: its decode reads no
position and holds O(1) state) served with no ``extra`` inputs replays
each decode step from one CUDA graph (``DecodeGraph``), captured at the
Server's first call at that batch: issuing a step is then one graph
launch instead of ~900 eager ops.  The counters
``serve.decode_graph_captures`` and ``serve.decode_graph_steps`` (a step
replayed) say so.  Every other stack, and every stack on the CPU, issues
``decode_step`` op by op.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
        recurrentgemma-9b --smoke --device cpu --batch 4 --prompt-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
        mamba2-130m --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
        whisper-large-v3 --smoke --device cpu

whisper-large-v3 and llama-3.2-vision-90b take the stub frontends'
embeddings, drawn after the prompts from the same numpy generator (seed
0), as the reference's ``main`` draws them: ``frames`` (batch,
encoder_seq, d) and ``image_embeds`` (batch, n_image_tokens, d).  On the
card (the default device) drop ``--device cpu``; ``chip_smoke.py``'s
``[serve*]`` phases serve the full-width models.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import Clovis, StreamContext, clovis_appender
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as mdl
from repro_torch.models.transformer import SSD, stack_kinds
from repro_torch.tree import leaves

DECODE_SPANS = ("serve.decode.issue", "serve.decode.wait", "serve.decode.log")
GRAPH_WARMUP = 3


def graphs_decode(cfg, device: torch.device, extra=None) -> bool:
    """Whether ``Server.generate`` replays its decode steps from a CUDA
    graph: on a CUDA device, with no ``extra`` inputs, for a stack whose
    every block is SSD (a decode step that reads no position and holds
    O(1) state, so one captured step serves every position)."""
    return (device.type == "cuda" and not extra
            and all(k == SSD for ks in stack_kinds(cfg).values()
                    for k in ks))


class DecodeGraph:
    """One ``decode_step`` at batch ``batch`` and its argmax, captured in
    a ``torch.cuda.CUDAGraph`` over static buffers: the token ``tok``
    (batch, 1) long, the cache tree ``cache`` (``init_decode_state``'s
    shapes) and the logits ``logits`` (batch, vocab) f32.  A replay reads
    ``tok`` and ``cache``, writes the step's state and conv tail back into
    ``cache`` and its argmax into ``tok``; ``logits`` is overwritten by
    the next replay."""

    def __init__(self, params, cfg, batch: int, max_len: int,
                 dtype: torch.dtype, device: torch.device):
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
        self.cache = mdl.init_decode_state(cfg, batch, max_len,
                                           dtype=dtype, device=device)
        self._leaves = leaves(self.cache)

        def step():
            logits, cache = mdl.decode_step(params, self.tok, 0, cfg,
                                            self.cache)
            torch._foreach_copy_(self._leaves, leaves(cache))
            self.tok.copy_(logits.argmax(-1)[:, None])
            return logits

        # warm-up outside the capture (cuBLAS handles, the allocator) on
        # the static buffers, which hold nothing yet
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the token log's consumer thread may call into CUDA
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.logits = step()
        trace.count("serve.decode_graph_captures")

    def load(self, cache, tok: torch.Tensor):
        """Start from a prefill's cache tree and its token (b, 1)."""
        torch._foreach_copy_(self._leaves, leaves(cache))
        self.tok.copy_(tok)

    def replay(self):
        self.graph.replay()
        trace.count("serve.decode_graph_steps")


class Server:
    def __init__(self, cfg, root: Path, *, device: DeviceLike = None,
                 use_kernels: bool = True, max_len: int = 256,
                 params: Optional[Dict] = None, log_tokens: bool = True):
        """``params``: a parameter tree already on ``device`` (for example
        ``models.convert.params_from_jax``); else random weights drawn on
        the device from seed 0, as the reference draws from key 0."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.max_len = max_len
        self.clovis = Clovis(root, device=self.device)
        self.params = params if params is not None else mdl.init_params(
            cfg, device=self.device)
        self._graphs: Dict[Tuple[int, torch.dtype], DecodeGraph] = {}
        self._stream = self._appender = None
        if log_tokens:
            self._appender = clovis_appender(self.clovis,
                                             container="servelog")
            self._stream = StreamContext(n_producers=1, consumer_ratio=15,
                                         attach=self._appender)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate(self, tokens: np.ndarray, gen: int, extra=None, *,
                 keep_logits: bool = False):
        """tokens: (batch, prompt_len) ints -> ((batch, gen) int32, stats).
        ``extra``: more batch inputs (``frames``, ``image_embeds``; numpy
        arrays or tensors), moved to the server's device.  With
        ``keep_logits`` the stats also hold ``logits``: the f32 (batch,
        vocab) logits of the prefill and of every decode step, on the
        device."""
        b, plen = tokens.shape
        dtype = (torch.float32 if self.cfg.dtype == "float32"
                 else torch.bfloat16)
        with trace.unit("serve.generate", batch=b, prompt_len=plen,
                        gen=gen) as rec:
            graph = None
            if graphs_decode(self.cfg, self.device, extra):
                graph = self._graphs.get((b, dtype))
                if graph is None:
                    graph = self._graphs[b, dtype] = DecodeGraph(
                        self.params, self.cfg, b, self.max_len, dtype,
                        self.device)
            cache = mdl.init_decode_state(self.cfg, b, self.max_len,
                                          device=self.device, dtype=dtype)
            batch = {"tokens": torch.as_tensor(np.asarray(tokens),
                                               dtype=torch.long)}
            for k, v in (extra or {}).items():
                batch[k] = torch.as_tensor(v).to(self.device)
            self._sync()
            with trace.span("serve.prefill"):
                logits, cache = mdl.prefill(self.params, batch, self.cfg,
                                            cache,
                                            use_kernels=self.use_kernels)
                self._sync()
            kept = [logits] if keep_logits else None

            out = np.zeros((b, gen), np.int32)
            tok = logits.argmax(-1)[:, None]
            for i in range(gen):
                # the token of step i - 1 (-1: the prefill's)
                with trace.span("serve.decode.wait", step=i - 1):
                    out[:, i] = tok[:, 0].cpu().numpy()
                if i:
                    trace.count("serve.decode_tokens_returned")
                if self._stream is not None:
                    with trace.span("serve.decode.log", step=i - 1):
                        self._stream.push(0, "tokens", out[:, i])
                with trace.span("serve.decode.issue", step=i):
                    if graph is not None:
                        if i == 0:
                            graph.load(cache, tok)
                            tok, cache = graph.tok, None
                        graph.replay()
                        if keep_logits:
                            kept.append(graph.logits.clone())
                    else:
                        logits, cache = mdl.decode_step(
                            self.params, tok, plen + i, self.cfg, cache)
                        if keep_logits:
                            kept.append(logits)
                        tok = logits.argmax(-1)[:, None]
                trace.count("serve.decode_steps")
            with trace.span("serve.decode.wait", step=gen - 1):
                self._sync()
        t_prefill = rec.seconds["serve.prefill"]
        t_decode = sum(rec.seconds.get(n, 0.0) for n in DECODE_SPANS)
        stats = {"prefill_s": t_prefill, "decode_s": t_decode,
                 "tok_per_s": b * gen / max(t_decode, 1e-9)}
        if keep_logits:
            stats["logits"] = kept
        return out, stats

    def close(self):
        """Drain the token stream and append its tail to the log."""
        if self._stream is not None:
            self._stream.close()
            self._appender.flush()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--root", default="sage_serve")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.scaled(dtype="float32")
    srv = Server(cfg, root=Path(args.root), device=args.device,
                 max_len=args.prompt_len + args.gen + 8)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_real,
                           (args.batch, args.prompt_len)).astype(np.int32)
    extra = {}
    if cfg.is_encoder_decoder:
        extra["frames"] = rng.standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.cross_attn_period:
        extra["image_embeds"] = rng.standard_normal(
            (args.batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    out, stats = srv.generate(prompts, args.gen, extra=extra)
    print(f"generated {out.shape} tokens; "
          f"prefill {stats['prefill_s']*1e3:.1f}ms, "
          f"decode {stats['tok_per_s']:.1f} tok/s")
    srv.close()


if __name__ == "__main__":
    main()
