"""The paper's LeNet-5-style CNN (the paper measures a modified 4b LeNet-5
on-chip), served through the CIM engine.

Counterpart of `repro/models/cnn.py` in engine mode: every layer - conv1
-> pool -> conv2 -> pool -> fc1 -> fc2 - runs through one compiled program
whose tiles go through the cim_mbiw kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.cim_layers import (CIMConfig, _engine_config,
                                         init_cim_linear)
from repro_torch.core.mapping import LayerSpec, conv_layer_spec
from repro_torch.runtime.program import (DEFAULT_BUCKETS, Device,
                                         compile_program)


def init_lenet(generator: torch.Generator, n_classes: int = 10,
               in_ch: int = 1, cim: Optional[CIMConfig] = None) -> Dict:
    """Name-keyed LeNet parameters, drawn on the host from `generator`."""
    return {
        "conv1": init_cim_linear(generator, 3 * 3 * in_ch, 16, cfg=cim),
        "conv2": init_cim_linear(generator, 3 * 3 * 16, 32, cfg=cim),
        "fc1": init_cim_linear(generator, 32 * 7 * 7, 128, cfg=cim),
        "fc2": init_cim_linear(generator, 128, n_classes, cfg=cim),
    }


LENET_LAYER_ORDER = ("conv1", "conv2", "fc1", "fc2")


def lenet_engine_specs(batch: int, h: int = 28, w: int = 28, in_ch: int = 1,
                       n_classes: int = 10,
                       cim: Optional[CIMConfig] = None
                       ) -> Tuple[List[LayerSpec], List[str], List[int]]:
    """The LeNet network as one engine schedule: conv-tagged + dense
    LayerSpecs with matching activations and max-pool epilogues."""
    cim = cim if cim is not None else CIMConfig()
    r = dict(r_in=cim.r_in, r_w=cim.r_w, r_out=cim.r_out)
    ph, pw = h // 2, w // 2                 # after each 2x2 max-pool
    qh, qw = ph // 2, pw // 2
    specs = [
        conv_layer_spec(batch, h, w, in_ch, 16, kh=3, kw=3, padding=1, **r),
        conv_layer_spec(batch, ph, pw, 16, 32, kh=3, kw=3, padding=1, **r),
        LayerSpec(m=batch, k=32 * qh * qw, n=128, **r),
        LayerSpec(m=batch, k=128, n=n_classes, **r),
    ]
    return specs, ["relu", "relu", "relu", "none"], [2, 2, 1, 1]


def lenet_program(batch: int, h: int = 28, w: int = 28, in_ch: int = 1,
                  n_classes: int = 10, cim: Optional[CIMConfig] = None,
                  device: Device = None):
    """The whole LeNet as one compiled CIMProgram from the module-level
    program cache (`prog.bind(lenet_params_list(params)).serve(images)`);
    runs on CUDA unless `device` names another."""
    cim = cim if cim is not None else CIMConfig()
    specs, acts, pools = lenet_engine_specs(batch, h, w, in_ch, n_classes,
                                            cim)
    return compile_program(specs, _engine_config(cim), activations=acts,
                           pools=pools, device=device)


def lenet_params_list(params: Dict) -> List[Dict]:
    """init_lenet's name-keyed params in the engine's positional order."""
    return [params[name] for name in LENET_LAYER_ORDER]


def lenet_forward(params: Dict, x: torch.Tensor, cim: CIMConfig,
                  key: Optional[torch.Tensor] = None,
                  device: Device = None) -> torch.Tensor:
    """x (B, 28, 28, C) -> logits, with cim.mode == "engine": the whole
    network through one cached program, dispatched through its bucket
    ladder (weights bound per call).  With cim.noise enabled the engine
    runs in its noise-injected mode and `key` (`core/prng.key`) seeds
    the noise model.  The other layer modes are not ported."""
    if cim.mode != "engine":
        raise NotImplementedError(
            f"lenet_forward mode {cim.mode!r} is not ported; use "
            "mode=\"engine\"")
    b, h, w, c = x.shape
    prog = lenet_program(DEFAULT_BUCKETS.bucket_for(b), h, w, c,
                         params["fc2"]["w"].shape[1], cim, device=device)
    return prog.serve(lenet_params_list(params), x, key)
