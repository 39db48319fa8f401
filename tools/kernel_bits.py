#!/usr/bin/env python3
"""Hash the outputs of the port's attention kernels 1-3 on the card, to show
that a change to their sources leaves the bits of existing shapes as they
were.

Run it once against each checkout's ``src`` directory (each builds its own
kernel library under its own ``build/``), then compare the two files::

    python3 tools/kernel_bits.py OLD/src > old.json
    python3 tools/kernel_bits.py src > new.json
    python3 tools/kernel_bits.py --compare old.json new.json

The cases: kernel 1 (prefill) at (d_qk, d_v) = (128, 128) with G = 4 and 8,
(112, 112), (96, 64) and (64, 64), causal and not, at 12 to 2,048 tokens,
a suffix at ``q_offset`` 464 and a 12 x 1,500 cross shape; kernel 2
(contiguous decode) at d = 128 (G = 4, 5, 8), 112 and 64 over ragged
lengths up to 1,024 and 1,500; kernel 3 (paged decode) at d = 128.  Every
input is drawn from one seeded generator on the card, in a fixed order,
so two checkouts see the same inputs.  Calls use only arguments that every
version of the wrappers takes.  Prints one JSON object, case -> sha256
prefix of the output's bits; ``--compare`` prints how many agree and
exits non-zero if any differ.
"""

import hashlib
import json
import sys


def _hash(torch, t) -> str:
    view = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    return hashlib.sha256(t.contiguous().view(view).cpu().numpy().tobytes()).hexdigest()[:16]


def kernel_hashes(src: str) -> dict[str, str]:
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    out = {}
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    for d, dv, hq, kh in ((128, 128, 32, 8), (128, 128, 32, 4), (112, 112, 32, 32),
                          (96, 64, 40, 40), (64, 64, 20, 20)):
        for causal in (True, False):
            for sq, sk, off in ((12, 12, 0), (478, 478, 0), (14, 478, 464),
                                (2048, 2048, 0), (12, 1500, 0)):
                if causal and sq != sk and off == 0:
                    continue
                q = rnd(1, sq, hq, d).to(torch.bfloat16)
                k = rnd(1, sk, kh, d).to(torch.bfloat16)
                v = rnd(1, sk, kh, dv).to(torch.bfloat16)
                o = flash_attention(q, k, v, q_offset=off, causal=causal)
                out[f"k1 d={d}/{dv} H={hq} K={kh} causal={causal} {sq}x{sk}+{off}"] = (
                    _hash(torch, o))
    for d, hq, kh in ((128, 32, 8), (128, 32, 4), (128, 40, 8), (112, 32, 32),
                      (64, 20, 20), (64, 8, 1)):
        for s in (1024, 1500):
            b = 16
            lens = torch.randint(1, s + 1, (b,), generator=g, device="cuda",
                                 dtype=torch.int32)
            lens[0], lens[1] = 1, s
            q = rnd(b, 1, hq, d).to(torch.bfloat16)
            kc, vc = rnd(b, s, kh, d), rnd(b, s, kh, d)
            out[f"k2 d={d} H={hq} K={kh} S={s}"] = _hash(torch, decode_attention(q, kc, vc,
                                                                                 lens))
            if d == 128 and s == 1024:
                ps = 16
                pk, pv = (t.view(b * s // ps, ps, kh, d) for t in (kc, vc))
                tables = torch.arange(b * s // ps, device="cuda",
                                      dtype=torch.int32).view(b, -1)
                out[f"k3 d={d} H={hq} K={kh}"] = _hash(
                    torch, paged_decode_attention(q, pk, pv, tables, lens))
    torch.cuda.synchronize()
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--compare":
        a, b = (json.load(open(p)) for p in argv[1:])
        differ = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        print(f"{len(a) - len(differ)} of {len(a)} outputs equal; differ: {differ}")
        return 1 if differ else 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps(kernel_hashes(argv[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
