"""Seeded Monte-Carlo accuracy-vs-noise sweep through the engine fast path,
on the PyTorch port.

Counterpart of `examples/noise_sweep.py`.  It briefly trains a LeNet on
pseudo-MNIST, then runs the whole noise model - thermal kT/C,
per-physical-column SA offsets with 7b calibration residue, DPL settling
INL, MBIW charge injection, leakage droop - through the deployed engine
schedule (the cim_mbiw kernel and the threefry_normal draw on the card),
so a Monte-Carlo sweep costs kernel launches instead of behavioural-sim
wall time:

  PYTHONPATH=src python examples/torch_noise_sweep.py [--device cpu]

Every trial is seeded from `repro_torch.core.prng` (JAX's threefry bit
for bit), so on the CPU this prints `examples/noise_sweep.py`'s numbers
within the warm-up training's float rounding.  Runs on the card unless
`--device` names another device.
"""
import argparse

import torch

from repro_torch.core import prng
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.core.noise_model import NoiseConfig
from repro_torch.data.pseudo_mnist import make_dataset
from repro_torch.models.cnn import (init_lenet, lenet_engine, lenet_forward,
                                    lenet_params_list, train_step)
from repro_torch.optim import AdamWConfig, adamw_init

BATCH, TRIALS, TRAIN_STEPS = 64, 8, 120

# max_gamma is capped below the 32x ladder ceiling: the ABN zoom amplifies
# the input-referred thermal / offset noise along with the signal (Fig.
# 18), so an aggressive untrained gamma drowns in noise
CIM_EVAL = dict(r_in=4, r_w=2, max_gamma=8.0)
SCALES = (0.0, 0.1, 0.25, 0.5, 1.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    xtr, ytr, xte, yte = make_dataset(n_train=2048, n_test=BATCH)
    xtr = torch.from_numpy(xtr).to(dev)[..., None]
    imgs = torch.from_numpy(xte).to(dev)[..., None]
    ytr = torch.from_numpy(ytr).long().to(dev)
    labels = torch.from_numpy(yte).long().to(dev)

    # a quick warm-up in bypass, so the sweep degrades something real
    cim_train = CIMConfig(mode="bypass")
    params = init_lenet(prng.key(0, dev), cim=CIMConfig(**CIM_EVAL))
    opt, ocfg = adamw_init(params), AdamWConfig(lr=2e-3, weight_decay=0.0)
    for leaf in (p for lay in params.values() for p in lay.values()):
        leaf.requires_grad_(True)
    loss = None
    for i in range(TRAIN_STEPS):
        s = (i * 128) % (len(xtr) - 128)
        loss = train_step(lenet_forward, params, opt, xtr[s:s + 128],
                          ytr[s:s + 128], None, cim_train, ocfg)
    params = {n: {k: v.detach() for k, v in lay.items()}
              for n, lay in params.items()}

    base = NoiseConfig()                                # measured defaults
    print(f"LeNet-on-pseudo-MNIST (warm-up loss {float(loss):.3f}), 4b "
          f"engine, {TRIALS} seeded trials/point")
    print("noise_scale  acc_mean  acc_std   logit_rms_dev")
    # one noise-enabled engine for every operating point: the sigma /
    # offset terms are per-call operands (noise= override)
    plist = lenet_params_list(params)
    eng_noisy = lenet_engine(BATCH, cim=CIMConfig(mode="engine", noise=base,
                                                  **CIM_EVAL), device=dev)
    eng_clean = lenet_engine(BATCH, cim=CIMConfig(
        mode="engine", noise=NoiseConfig.none(), **CIM_EVAL), device=dev)
    clean = eng_clean(plist, imgs)
    rows = []
    for scale in SCALES:
        if scale > 0:
            point = base.replace(
                thermal_rms_lsb8=base.thermal_rms_lsb8 * scale,
                sa_sigma_v=base.sa_sigma_v * scale)
            logits = eng_noisy.monte_carlo(plist, imgs, prng.key(1), TRIALS,
                                           noise=point)
        else:
            logits = clean[None]                         # deterministic
        accs = torch.mean((torch.argmax(logits, -1)
                           == labels[None, :]).to(torch.float32), dim=-1)
        rms = float(torch.sqrt(torch.mean((logits - clean[None]) ** 2)))
        std = float(torch.std(accs, correction=0))      # as jnp.std
        rows.append({"scale": scale, "acc_mean": float(torch.mean(accs)),
                     "acc_std": std, "logit_rms_dev": rms})
        print(f"  x{scale:<9g} {rows[-1]['acc_mean']:8.3f} {std:8.3f} "
              f"{rms:12.4f}")

    # the perf report echoes the noise operating point beside the energy
    # model (the IMAGINE macro's projection, not a measurement)
    rep = lenet_engine(BATCH, cim=CIMConfig(mode="engine", noise=base,
                                            **CIM_EVAL),
                       device=dev).perf_report()
    print(f"\nperf_report noise echo: enabled={rep['noise']['enabled']}, "
          f"thermal={rep['noise']['thermal_rms_lsb8']} LSB8, "
          f"sa_sigma={rep['noise']['sa_sigma_v'] * 1e3:.0f} mV "
          f"(x{rep['noise']['sa_postlayout_mult']} post-layout), "
          f"modeled {rep['total']['tops_per_w']:.1f} TOPS/W")
    return {"warmup_loss": float(loss), "rows": rows}


if __name__ == "__main__":
    main()
