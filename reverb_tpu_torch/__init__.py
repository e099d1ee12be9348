"""reverb_tpu_torch — the PyTorch/CUDA port of reverb_tpu for NVIDIA Hopper.

The package mirrors reverb_tpu's module paths (frontend/, models/, ops/,
decode/, cli/, train/).  It imports torch and never jax: the serving path
(fbank → LSL conformer → CTC prefix beam → attention rescoring), every
other decode mode of reverb_tpu (decode/api.py) and the training step
(train/trainer.py) run as PyTorch ops plus hand-written CUDA kernels
(csrc/, built on first use by _build.py).  Public API as in reverb_tpu:
``load_model(...)`` returns a ``ReverbASR`` with ``.transcribe(...)`` /
``.transcribe_modes(...)``; ``init_model(configs, ...)`` builds the
trainable bundle of the model family a config names (models/registry.py).
"""

__version__ = "0.1.0"


def load_model(model: str, **kwargs):
    """Load a Reverb ASR model directory (config.yaml + *.pt/*.npz)."""
    from reverb_tpu_torch.cli.reverb import load_model as _load_model
    return _load_model(model, **kwargs)


def __getattr__(name):
    if name == "ReverbASR":
        from reverb_tpu_torch.cli.reverb import ReverbASR
        return ReverbASR
    raise AttributeError(
        f"module 'reverb_tpu_torch' has no attribute {name!r}")


def init_model(configs, generator=None, device='cuda', **kwargs):
    """A trainable model bundle (kind, cfg, model, loss_fn) of the family
    a config names (models/registry.py:init_model)."""
    from reverb_tpu_torch.models.registry import init_model as _init_model
    return _init_model(configs, generator, device, **kwargs)
