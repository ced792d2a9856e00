"""One config per assigned architecture (--arch <id>)."""
import importlib

ARCHS = {
    "whisper-small": "whisper_small",
    "mixtral-8x7b": "mixtral_8x7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "gemma-2b": "gemma_2b",
    "smollm-360m": "smollm_360m",
    "glm4-9b": "glm4_9b",
    "olmo-1b": "olmo_1b",
    "internvl2-1b": "internvl2_1b",
    "mamba2-130m": "mamba2_130m",
    "jamba-1.5-large-398b": "jamba_1_5_large",
}


def get_config(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choices: {list(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG
