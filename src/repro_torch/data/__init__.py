from repro_torch.data.synthetic import SyntheticLM, batch_specs

__all__ = ["SyntheticLM", "batch_specs"]
