"""Batched serving driver: prefill + greedy decode with KV/state caches
(the port of ``repro.launch.serve``).

The prefill runs the attention, RG-LRU and SSD layers through the
hand-written kernels B5, B7 and B6 on the card (``use_kernels=True``,
the default); decode is plain torch, as in the reference.  Served tokens are
offloaded to a StreamContext consumer that appends to the port's Clovis
(container ``servelog``, object ``stream/tokens``: int32, one row of
``batch`` tokens per step), and each ``generate`` call leaves an ADDB
``serve/generate`` record.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
        recurrentgemma-9b --smoke --device cpu --batch 4 --prompt-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \\
        mamba2-130m --smoke --device cpu

On the card (the default device) drop ``--device cpu``;
``chip_smoke.py``'s ``[serve]`` and ``[serve-ssm]`` phases serve the
full-width recurrentgemma-9b and mamba2-130m.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import Clovis, StreamContext, clovis_appender
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as mdl


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
        With ``keep_logits`` the stats also hold ``logits``: the f32
        (batch, vocab) logits of the prefill and of every decode step, on
        the device."""
        b, plen = tokens.shape
        cache = mdl.init_decode_state(
            self.cfg, b, self.max_len, device=self.device,
            dtype=torch.float32 if self.cfg.dtype == "float32"
            else torch.bfloat16)
        batch = {"tokens": torch.as_tensor(np.asarray(tokens),
                                           dtype=torch.long)}
        if extra:
            batch.update(extra)
        self._sync()
        t0 = time.time()
        logits, cache = mdl.prefill(self.params, batch, self.cfg, cache,
                                    use_kernels=self.use_kernels)
        self._sync()
        t_prefill = time.time() - t0
        kept = [logits] if keep_logits else None

        out = np.zeros((b, gen), np.int32)
        tok = logits.argmax(-1)[:, None]
        t0 = time.time()
        for i in range(gen):
            out[:, i] = tok[:, 0].cpu().numpy()
            if self._stream is not None:
                self._stream.push(0, "tokens", out[:, i])
            logits, cache = mdl.decode_step(self.params, tok, plen + i,
                                            self.cfg, cache)
            if keep_logits:
                kept.append(logits)
            tok = logits.argmax(-1)[:, None]
        self._sync()
        t_decode = time.time() - t0
        self.clovis.addb.record("serve", "generate", "-",
                                b * gen, t_prefill + t_decode)
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
    out, stats = srv.generate(prompts, args.gen)
    print(f"generated {out.shape} tokens; "
          f"prefill {stats['prefill_s']*1e3:.1f}ms, "
          f"decode {stats['tok_per_s']:.1f} tok/s")
    srv.close()


if __name__ == "__main__":
    main()
