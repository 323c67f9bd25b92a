"""End-to-end driver on the PyTorch port: train a CIM-quantized LeNet on
pseudo-MNIST with the CIM-aware training loop (noise injection + learned
ABN), then evaluate under the voltage-domain behavioural macro and the
engine - the paper's co-design flow.

Counterpart of `examples/train_lenet_cim.py`.  The step is
`models/cnn.train_step` (chip_smoke.py's `cnn_train` phase runs the same
one), the draws come from `repro_torch.core.prng` (JAX's threefry bit for
bit), so on the CPU this prints `examples/train_lenet_cim.py`'s numbers.

  PYTHONPATH=src python examples/torch_train_lenet_cim.py [--epochs 4] \\
      [--device cpu]

Runs on the card unless `--device` names another device.
"""
import argparse
import time

import torch

from repro_torch.core import prng
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.core.noise_model import NoiseConfig
from repro_torch.data.pseudo_mnist import make_dataset
from repro_torch.models.cnn import (init_lenet, lenet_engine, lenet_forward,
                                    train_step)
from repro_torch.optim import AdamWConfig, adamw_init


def accuracy(params, x, y, cim, device=None) -> float:
    with torch.no_grad():
        logits = lenet_forward(params, x, cim, device=device)
    return float(torch.mean((torch.argmax(logits, -1) == y).to(
        torch.float32)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # CIM-aware training: fakequant + post-silicon noise (Sec. III.E)
    cim_train = CIMConfig(mode="fakequant", noise=NoiseConfig())
    cim_eval = CIMConfig(mode="fakequant")

    xtr, ytr, xte, yte = make_dataset(n_train=4096, n_test=1024)
    xtr = torch.from_numpy(xtr).to(dev)[..., None]
    xte = torch.from_numpy(xte).to(dev)[..., None]
    ytr = torch.from_numpy(ytr).long().to(dev)
    yte = torch.from_numpy(yte).long().to(dev)

    params = init_lenet(prng.key(0, dev), cim=cim_train)
    for lay in params.values():
        for leaf in lay.values():
            leaf.requires_grad_(True)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=1e-3, weight_decay=0.0)

    key = prng.key(1)
    t0 = time.time()
    losses, accs = [], []
    for epoch in range(args.epochs):
        for i in range(0, len(xtr), args.batch):
            key, sub = prng.split(key)
            loss = train_step(lenet_forward, params, opt,
                              xtr[i:i + args.batch], ytr[i:i + args.batch],
                              sub, cim_train, ocfg)
            losses.append(float(loss))
        accs.append(accuracy(params, xte, yte, cim_eval))
        print(f"epoch {epoch}: loss={losses[-1]:.3f} "
              f"test_acc={accs[-1]:.3f} ({time.time()-t0:.0f}s)")

    # deployment check: the first 128 test images through the
    # voltage-domain macro simulation (Sec. III fidelity)
    acc_sim = accuracy(params, xte[:128], yte[:128],
                       cim_eval.replace(mode="sim"))
    print(f"voltage-domain macro eval (128 imgs): acc={acc_sim:.3f}")

    # inference-runtime check: the same images through the engine's conv
    # front-end (im2col streaming -> the cim_mbiw kernel)
    with torch.no_grad():
        logits_eng = lenet_forward(params, xte[:128],
                                   cim_eval.replace(mode="engine"),
                                   device=dev)
        logits_fq = lenet_forward(params, xte[:128], cim_eval)
    acc_eng = float(torch.mean((torch.argmax(logits_eng, -1)
                                == yte[:128]).to(torch.float32)))
    agree = float(torch.mean((torch.argmax(logits_eng, -1)
                              == torch.argmax(logits_fq, -1)).to(
                                  torch.float32)))
    rep = lenet_engine(128, cim=cim_eval, device=dev).perf_report()["total"]
    print(f"engine eval (128 imgs): acc={acc_eng:.3f}, top-1 agreement with "
          f"fakequant={agree:.3f}, modeled {rep['tops_per_w']:.1f} TOPS/W")
    return {"losses": losses, "test_acc": accs, "acc_sim": acc_sim,
            "acc_engine": acc_eng, "agreement": agree}


if __name__ == "__main__":
    main()
