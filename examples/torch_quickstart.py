"""Quickstart on the PyTorch port: the paper's technique in 30 lines.

Counterpart of `examples/quickstart.py`.  A CIM-quantized linear layer
with distribution-aware reshaping (ABN), compared against (a) full
precision and (b) unity-gain quantization - the paper's Fig. 3 argument
on one matmul - then the precision-scalable engine and a LeNet through
one engine plan.  Draws come from `repro_torch.core.prng`, JAX's threefry
bit for bit, so on the CPU this prints `examples/quickstart.py`'s
numbers.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless `--device` names another device.
"""
import argparse

import torch

from repro_torch.core import prng
from repro_torch.core.cim_layers import (CIMConfig, cim_linear_apply,
                                         init_cim_linear)
from repro_torch.core.mapping import LayerSpec
from repro_torch.data.pseudo_mnist import make_dataset
from repro_torch.models.cnn import (init_lenet, lenet_forward,
                                    lenet_params_list, lenet_program)
from repro_torch.runtime import compile_program


def rel_norm(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    out = {}

    cfg = CIMConfig(mode="fakequant")          # 8b in, 4b weights, 8b ADC
    # a layer that uses 4 of the macro's 32 serial-split units (K=144)
    params = init_cim_linear(prng.key(0, dev), 144, 64, cfg=cfg)
    x = torch.relu(prng.normal(prng.key(1, dev), (256, 144)))

    y_fp = x @ params["w"]                                 # full precision
    y_cim = cim_linear_apply(params, x, cfg)               # IMAGINE path
    unity = {**params,
             "abn_log_gamma": torch.zeros_like(params["abn_log_gamma"])}
    y_unity = cim_linear_apply(unity, x, cfg)              # no reshaping
    out["rel_abn"], out["rel_unity"] = rel_norm(y_cim, y_fp), rel_norm(
        y_unity, y_fp)
    print(f"relative error, distribution-aware ABN : {out['rel_abn']:8.4f}")
    print(f"relative error, unity gain (no ABN)    : "
          f"{out['rel_unity']:8.4f}")
    print("-> the ABN 'zoom' recovers the ADC bits the narrow DP "
          "distribution would otherwise waste (paper Fig. 3).")

    # the same layer through the voltage-domain behavioural macro
    y_sim = cim_linear_apply(params, x[:16], cfg.replace(mode="sim"))
    out["sim_vs_fakequant"] = rel_norm(y_cim[:16], y_sim)
    print(f"voltage-domain sim vs fakequant        : "
          f"{out['sim_vs_fakequant']:8.4f}")

    # --- the precision-scalable inference runtime (paper Fig. 22) -------
    print("\nprecision-scalable engine (2-layer network, r_w = "
          "min(r_in, 4)):")
    out["engine"] = {}
    for r_in in (8, 4, 2, 1):
        specs = [LayerSpec(m=256, k=144, n=64, r_in=r_in, r_w=min(r_in, 4)),
                 LayerSpec(m=256, k=64, n=32, r_in=r_in, r_w=min(r_in, 4))]
        prog = compile_program(specs, device=dev)   # plan once (cached)
        eparams = prog.init_params(prng.key(2, dev))
        bound = prog.bind(eparams)             # weights pre-quantized
        y_eng = bound.serve(x)                 # the cim_mbiw kernel
        y_ref = bound.reference(x)             # digital oracle
        y_full = torch.relu(x @ eparams[0]["w"]) @ eparams[1]["w"]
        exact = bool(torch.equal(y_eng, y_ref))
        rel_fp = rel_norm(y_eng, y_full)
        ee = prog.perf_report()["total"]["tops_per_w"]
        out["engine"][r_in] = {"exact": exact, "rel_fp": rel_fp,
                               "tops_per_w": ee}
        print(f"  r_in={r_in}: bit-exact with reference: {exact}, rel err "
              f"vs fp: {rel_fp:6.4f}, modeled {ee:6.1f} TOPS/W")

    # --- conv front-end: a whole LeNet through one engine plan ----------
    _, _, xte, _ = make_dataset(n_train=1, n_test=32)
    imgs = torch.from_numpy(xte).to(dev)[..., None]         # (32, 28, 28, 1)
    lcfg = CIMConfig(mode="fakequant", r_in=4, r_w=2)      # the 4b LeNet
    lparams = init_lenet(prng.key(3, dev), cim=lcfg)
    logits_fq = lenet_forward(lparams, imgs, lcfg)
    logits_eng = lenet_forward(lparams, imgs, lcfg.replace(mode="engine"),
                               device=dev)
    lprog = lenet_program(imgs.shape[0], cim=lcfg, device=dev)
    lbound = lprog.bind(lenet_params_list(lparams))
    out["lenet_exact"] = bool(torch.equal(logits_eng,
                                          lbound.reference(imgs)))
    out["lenet_rel_fq"] = float(torch.max(torch.abs(logits_eng - logits_fq))
                                / (torch.max(torch.abs(logits_fq)) + 1e-9))
    rep = lprog.perf_report()["total"]
    print(f"\nLeNet conv front-end (pseudo-MNIST, 4b): bit-exact with "
          f"digital conv reference: {out['lenet_exact']}, rel err vs "
          f"fakequant: {out['lenet_rel_fq']:.2e}, modeled "
          f"{rep['tops_per_w']:.1f} TOPS/W over {rep['macro_evals']} "
          f"planned macro tiles")
    return out


if __name__ == "__main__":
    main()
