"""Serving example on the PyTorch port: batched generation with ring-buffer
sliding-window decode and the flash-decode kernel (the reference's
``serve_longcontext.py``).

    PYTHONPATH=src python examples/torch_serve_longcontext.py [--device cpu] \\
        [--decode-steps 64] [--window 16]

Generates from three architecture families (dense + SWA ring cache, Griffin
hybrid with O(1) recurrent state, xLSTM matrix memory) and shows that state
stays constant while decoding past the window, the mechanism behind the
long_500k input shape. Where the reference checks its Pallas decode kernel
(interpret mode) against its jnp path, the dense model decodes here on the
card through the ``swa_decode`` kernel and, from a copy of the same weights
on the CPU, through its plain version, and the two are compared; with
``--device cpu`` both runs take the plain version."""
import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_bytes, tree_map


def decode_run(arch: str, device: str, steps: int, window: int, params=None):
    """(logits (B, steps, V) fp32 on the CPU, cache bytes, seconds, params)
    of ``steps`` greedy decode steps of a batch of 2 from token 1."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0), device)
    params = tree_map(lambda p: p.to(device), params)
    cache = model.init_cache(params, {"tokens": torch.zeros((2, 1), dtype=torch.int32,
                                                            device=device)},
                             steps, window=window)
    tok = torch.ones((2, 1), dtype=torch.long, device=device)
    outs = []
    t0 = time.time()
    with torch.no_grad():
        for _ in range(steps):
            cache, logits = model.decode(params, cache, tok, window=window)
            tok = logits[:, :cfg.vocab_size].argmax(dim=-1, keepdim=True)
            outs.append(logits.float().cpu())
    if device != "cpu":
        torch.cuda.synchronize()
    return torch.stack(outs, 1), tree_bytes(cache), time.time() - t0, params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--decode-steps", type=int, default=64)   # 4x past the window
    ap.add_argument("--window", type=int, default=16)
    args = ap.parse_args(argv)
    steps, window = args.decode_steps, args.window

    state_bytes = {}
    for arch in ("mistral-nemo-12b", "recurrentgemma-2b", "xlstm-125m"):
        _, cache_bytes, dt, _ = decode_run(arch, args.device, steps, window)
        state_bytes[arch] = cache_bytes
        print(f"{arch:22s} decoded {steps} steps past a {window}-token window; "
              f"state={cache_bytes / 1e6:.2f} MB (constant); {dt:.1f}s")

    # the decode kernel (on the card) against its plain version (the CPU)
    a, _, _, params = decode_run("mistral-nemo-12b", args.device, steps, window)
    b, _, _, _ = decode_run("mistral-nemo-12b", "cpu", steps, window, params=params)
    err = float((a - b).abs().max() / (a.abs().max() + 1e-9))
    what = "swa_decode kernel" if args.device != "cpu" else "plain decode (CPU)"
    print(f"{what} vs the plain version on the CPU: rel err {err:.2e}")
    return {"state_bytes": state_bytes, "rel_err": err}


if __name__ == "__main__":
    main()
