"""Where B2 and its plain version part on a lane of the Cornell scan.

    python3 flip_trace.py [--launch 50] [--lanes 3]

On the card: the Cornell box's fused scan at 500x500, 32 bounces, 128
samples a pixel (the train step's), B2 at launch `--launch` against
`ad_step_fwd_plain` from the same entry state, each lane held to
`chip_smoke.compare_launch`'s rule; if every lane agrees there, the other
launches of the scan in order, to the first with a lane that does not. For
each of the first `--lanes` lanes
that do not agree, that launch is replayed on the lane alone one sub-step at
a time (a launch of one sub-step at the same global step), by the kernel, by
the plain version on the card and by the plain version on the CPU, to the
first sub-step whose exit state differs; that sub-step of the plain version
is then run on both devices under a recorder of every PyTorch operation, and
the first operation whose output differs between the two is printed with
its inputs, both outputs and the same operation in float64. The kernel's
exit state is printed beside both, so the line says which side the kernel
takes. Prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import chip_smoke as cs


class Recorder(TorchDispatchMode):
    """Every operation's name, inputs and outputs, copied to the host."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        host = lambda xs: [x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x
                           for x in tree_flatten(xs)[0]]
        self.ops.append((func, host((args, kwargs or {})), host(out)))
        return out


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))
    return a == b


def show(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32 and x.numel() <= 4:
        return ", ".join(f"{v:.9g} (0x{b & 0xffffffff:08x})"
                         for v, b in zip(x.flatten().tolist(), bits(x).flatten().tolist()))
    if isinstance(x, torch.Tensor) and x.numel() <= 4:
        return str(x.flatten().tolist())
    if isinstance(x, torch.Tensor):
        return f"tensor{tuple(x.shape)} {x.dtype}"
    return repr(x)


def in_float64(func, args):
    """The operation on float64 copies of its float32 inputs, or None."""
    try:
        a64 = [x.double() if isinstance(x, torch.Tensor) and x.dtype == torch.float32 else x
               for x in args]
        return func(*a64)
    except Exception:  # an operation with keyword-only or structured arguments
        return None


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--launch", type=int, default=50)
    parser.add_argument("--lanes", type=int, default=3)
    args = parser.parse_args()
    cs.check(torch.cuda.is_available(), "no CUDA device: this script needs a GPU")
    import miniraytracer_tpu_torch as mrt
    from miniraytracer_tpu_torch.ops import bounce, bounce_ad as A

    card = cs.card()
    print(card)
    dev = torch.device("cuda")
    scene = mrt.scenes.cornell_box(1.0).to(dev)
    meta, cfg, outer, tables, pix, sb, _, (res_f, res_i, res_k) = cs.launch_states(
        mrt, bounce, A, scene, 500, 500, 128, 32, False)
    n = 500 * 500
    zeros = torch.zeros((3, n), device=dev)

    def disagreeing(t):
        f_in = torch.cat([zeros, res_f[t], zeros[:2]])
        fk, ik, kk = A.ad_step_fwd(meta, cfg, tables, t, f_in, res_i[t], res_k[t], pix, sb)
        fp, ip, kp = A.ad_step_fwd_plain(meta, cfg, tables, t, f_in, res_i[t], res_k[t], pix, sb)
        tol = 1e-5 * (1 + fp.abs())
        tol[A.A_RO:A.A_RD] = 1e-5 * float(fp[A.A_RO:A.A_RD].abs().max().clamp_min(1.0))
        tol[A.A_ALIVE:] = 0.0
        agree = (ik == ip).all(0) & (kk == kp) & ((fk - fp).abs() <= tol).all(0)
        decided = (ik == ip).all(0) & (kk == kp) & (fk[A.A_ALIVE:] == fp[A.A_ALIVE:]).all(0)
        return f_in, torch.nonzero(~agree)[:, 0].tolist(), int((~decided).sum())

    # the launch asked for, then every launch of the scan until lanes disagree
    per_launch = {}
    for t in [args.launch] + [u for u in range(outer) if u != args.launch]:
        f_in, bad, flipped = disagreeing(t)
        per_launch[t] = (len(bad), flipped)
        print(f"launch {t} of {outer}: {n - len(bad)} of {n} lanes agree "
              f"({(n - len(bad)) / n:.5f}), {flipped} with another integer row, key, alive, "
              f"count or ray count; lanes that do not: {bad[:20]}")
        if bad:
            break
    print(f"launches compared {len(per_launch)}; lanes that disagree in them "
          f"{sum(v[0] for v in per_launch.values())}")
    cfg1 = A.StepConfig(cfg.width, cfg.height, cfg.sq_off, cfg.max_bounces, cfg.spp,
                        cfg.claim_limit, 1)
    tables_cpu = [x.cpu() for x in tables]
    for lane in bad[:args.lanes]:
        sel = torch.tensor([lane], device=dev)
        state = (f_in[:, sel].contiguous(), res_i[t][:, sel].contiguous(),
                 res_k[t][sel].contiguous(), pix[sel].contiguous(), sb[sel].contiguous())
        print(f"lane {lane} (pixel {int(pix[lane])}):")
        for j in range(cfg.k_sub):
            step = t * cfg.k_sub + j
            k_out = A.ad_step_fwd(meta, cfg1, tables, step, *state)
            g_out = A.ad_step_fwd_plain(meta, cfg1, tables, step, *state)
            c_in = tuple(x.cpu() for x in state)
            c_out = A.ad_step_fwd_plain(meta, cfg1, tables_cpu, step, *c_in)
            kg = all(same(a.cpu(), b.cpu()) for a, b in zip(k_out, g_out))
            kc = all(same(a.cpu(), b) for a, b in zip(k_out, c_out))
            gc = all(same(a.cpu(), b) for a, b in zip(g_out, c_out))
            print(f"  sub-step {j} (global step {step}): kernel = plain on the card: {kg}; "
                  f"kernel = plain on the CPU: {kc}; the two plain runs equal: {gc}")
            if not (kg and kc):
                rows = [r for r in range(A.NF)
                        if not (same(k_out[0][r].cpu(), g_out[0][r].cpu())
                                and same(k_out[0][r].cpu(), c_out[0][r]))]
                for r in rows[:8]:
                    print(f"    row {r}: kernel {show(k_out[0][r].cpu())}; plain on the card "
                          f"{show(g_out[0][r].cpu())}; on the CPU {show(c_out[0][r])}")
                print(f"    istate kernel {k_out[1].flatten().tolist()} card "
                      f"{g_out[1].flatten().tolist()} CPU {c_out[1].flatten().tolist()}")
                logs = []
                for d, xs, tabs in (("cuda", state, tables), ("cpu", c_in, tables_cpu)):
                    with Recorder() as rec:
                        A.ad_step_fwd_plain(meta, cfg1, tabs, step, *xs)
                    logs.append(rec.ops)
                first = next((i for i, (a, b) in enumerate(zip(*logs))
                              if not all(same(x, y) for x, y in zip(a[2], b[2]))), None)
                print(f"    the plain version's operations: {len(logs[0])} on the card, "
                      f"{len(logs[1])} on the CPU; first whose outputs differ: "
                      f"{'none' if first is None else first}")
                if first is not None:
                    func, ins, outs = logs[0][first]
                    _, ins_c, outs_c = logs[1][first]
                    inputs_equal = all(same(x, y) for x, y in zip(ins, ins_c))
                    print(f"    operation {first}: {func}; inputs equal on both: {inputs_equal}")
                    for x in ins[:4]:
                        print(f"      input {show(x)}")
                    print(f"      card  {show(outs[0])}")
                    print(f"      CPU   {show(outs_c[0])}")
                    r64 = in_float64(func, ins_c)
                    if isinstance(r64, torch.Tensor):
                        print(f"      float64 {', '.join(f'{v:.17g}' for v in r64.flatten()[:4].tolist())}")
                    for i in range(max(0, first - 6), first):
                        print(f"      before: {i} {logs[1][i][0]} -> {show(logs[1][i][2][0])}")
                break
            state = (k_out[0], k_out[1], k_out[2], state[3], state[4])
    print(card)


if __name__ == "__main__":
    main()
