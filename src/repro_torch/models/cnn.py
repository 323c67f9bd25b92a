"""The paper's own workloads: the 784-512-128-10 MLP of Fig. 3(b) and a
LeNet-5-style CNN (the paper measures a modified 4b LeNet-5 on-chip).

Counterpart of `repro/models/cnn.py`.  Every layer runs through the CIM
stack, so these models exercise the whole technique: adaptive-swing
activation quantization, bit-plane weights, DSCI-ADC output quantization
with learned per-channel ABN, and post-silicon noise injection during
training (modes bypass, fakequant and sim, layer by layer).  In engine
mode the whole LeNet - conv1 -> pool -> conv2 -> pool -> fc1 -> fc2 -
runs through one compiled program whose tiles go through the cim_mbiw
kernel.  Activations are NHWC, so the flatten before fc1 is in (h, w, c)
order, as in JAX.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import prng
from repro_torch.core.cim_layers import (CIMConfig, _engine_config,
                                         cim_conv2d_apply, cim_linear_apply,
                                         init_cim_linear)
from repro_torch.core.mapping import LayerSpec, conv_layer_spec
from repro_torch.runtime.program import (DEFAULT_BUCKETS, Device,
                                         compile_program)


Source = Union[torch.Generator, torch.Tensor]


def _layer_sources(source: Source, n: int) -> List[Source]:
    """One weight source per layer: a generator is drawn from in turn; a
    `core/prng` key splits into n keys, as `jax.random.split(key, n)`."""
    if isinstance(source, torch.Generator):
        return [source] * n
    return list(prng.split(source, n))


def init_mlp(source: Source, dims: Sequence[int] = (784, 512, 128, 10),
             cim: Optional[CIMConfig] = None) -> Dict:
    """Name-keyed MLP parameters {"fc0", "fc1", ...}.  `source` is a
    `torch.Generator` (drawn on its device) or a `core/prng` key, which
    draws the JAX package's weights bit for bit."""
    ks = _layer_sources(source, len(dims) - 1)
    return {f"fc{i}": init_cim_linear(ks[i], dims[i], dims[i + 1], cfg=cim)
            for i in range(len(dims) - 1)}


def mlp_forward(params: Dict, x: torch.Tensor, cim: CIMConfig,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, 784) -> logits (B, 10); relu between layers.  `key` (a host
    `core/prng` key) splits once per layer, as in JAX, and seeds each
    layer's noise."""
    n = len(params)
    for i in range(n):
        sub = None
        if key is not None:
            key, sub = prng.split(key)
        x = cim_linear_apply(params[f"fc{i}"], x, cim, key=sub)
        if i < n - 1:
            x = torch.relu(x)
    return x


def init_lenet(source: Source, n_classes: int = 10, in_ch: int = 1,
               cim: Optional[CIMConfig] = None) -> Dict:
    """Name-keyed LeNet parameters.  `source` is a `torch.Generator`
    (drawn on its device, layer after layer) or a `core/prng` key, which
    splits into five as JAX's `init_lenet` does and draws its weights bit
    for bit."""
    ks = _layer_sources(source, 5)
    return {
        "conv1": init_cim_linear(ks[0], 3 * 3 * in_ch, 16, cfg=cim),
        "conv2": init_cim_linear(ks[1], 3 * 3 * 16, 32, cfg=cim),
        "fc1": init_cim_linear(ks[2], 32 * 7 * 7, 128, cfg=cim),
        "fc2": init_cim_linear(ks[3], 128, n_classes, cfg=cim),
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


def lenet_engine(batch: int, h: int = 28, w: int = 28, in_ch: int = 1,
                 n_classes: int = 10, cim: Optional[CIMConfig] = None,
                 device: Device = None):
    """One `CIMInferenceEngine` running the whole LeNet (conv1 -> pool ->
    conv2 -> pool -> fc1 -> fc2) through the cim_mbiw kernel (the engine
    wraps the same cached program `lenet_program` returns); on CUDA
    unless `device` names another."""
    from repro_torch.runtime import CIMInferenceEngine
    cim = cim if cim is not None else CIMConfig()
    specs, acts, pools = lenet_engine_specs(batch, h, w, in_ch, n_classes,
                                            cim)
    return CIMInferenceEngine(specs, _engine_config(cim), activations=acts,
                              pools=pools, device=device)


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of `labels` under the log-softmax of
    `logits`: the loss of the examples' CNN training."""
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(lp, 1, labels[:, None].long()))


def train_step(fwd, params: Dict, opt: Dict, xb: torch.Tensor,
               yb: torch.Tensor, key: Optional[torch.Tensor], cim: CIMConfig,
               ocfg) -> torch.Tensor:
    """One step of the examples' CNN training (`examples/
    train_lenet_cim.py`'s jitted step): `nll` of fwd(params, xb, cim,
    key=key), its gradients by autograd (zero for a leaf the loss does not
    reach, as under jax.grad), AdamW (`ocfg`) applied to `params` and
    `opt` in place.  Returns the loss, detached."""
    from repro_torch.optim import adamw_update
    from repro_torch.optim.adamw import tree_leaves
    loss = nll(fwd(params, xb, cim, key=key), yb)
    leaves = tree_leaves(params)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    adamw_update(params, grads, opt, ocfg)
    return loss.detach()


def lenet_params_list(params: Dict) -> List[Dict]:
    """init_lenet's name-keyed params in the engine's positional order."""
    return [params[name] for name in LENET_LAYER_ORDER]


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, "VALID", over NHWC: JAX's
    `reduce_window(x, -inf, max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")`
    with its gradient.  Of equal values in a window the gradient goes to
    the first in row-major order, where XLA's select-and-scatter puts it:
    pseudo-MNIST and quantized activations tie often."""
    b, h, w, c = x.shape
    hh, wh = h // 2, w // 2
    win = x[:, :2 * hh, :2 * wh, :].reshape(b, hh, 2, wh, 2, c)
    win = win.permute(0, 1, 3, 5, 2, 4).reshape(b, hh, wh, c, 4)
    # argmax returns the first of equal maxima: window order (0,0), (0,1),
    # (1,0), (1,1), row-major
    idx = torch.argmax(win, dim=-1, keepdim=True)
    return torch.gather(win, -1, idx).squeeze(-1)


def lenet_forward(params: Dict, x: torch.Tensor, cim: CIMConfig,
                  key: Optional[torch.Tensor] = None,
                  device: Device = None) -> torch.Tensor:
    """x (B, 28, 28, C) NHWC -> logits.

    mode="engine" runs the whole network - conv1/conv2/fc1/fc2 plus the
    pooling and flatten epilogues - through one compiled program from the
    module-level cache (`lenet_program`, on `device`, CUDA unless it names
    another), dispatched through its bucket ladder (weights bound per
    call); with cim.noise enabled it runs in its noise-injected mode.
    Every other mode runs layer by layer on x's device (conv through
    `cim_conv2d_apply`, relu, `max_pool_2x2`), differentiable in bypass
    and fakequant; `key` (a host `core/prng` key) splits once per layer,
    as JAX's `nk()` does, and seeds each layer's noise."""
    if cim.mode == "engine":
        b, h, w, c = x.shape
        prog = lenet_program(DEFAULT_BUCKETS.bucket_for(b), h, w, c,
                             params["fc2"]["w"].shape[1], cim, device=device)
        return prog.serve(lenet_params_list(params), x, key)

    def nk():
        nonlocal key
        if key is None:
            return None
        key, sub = prng.split(key)
        return sub

    h = torch.relu(cim_conv2d_apply(params["conv1"], x, cim, key=nk()))
    h = max_pool_2x2(h)
    h = torch.relu(cim_conv2d_apply(params["conv2"], h, cim, key=nk()))
    h = max_pool_2x2(h)
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(cim_linear_apply(params["fc1"], h, cim, key=nk()))
    return cim_linear_apply(params["fc2"], h, cim, key=nk())
