# The paper's storage model, reconstruction, plans, engine — the
# PyTorch mirror of ``repro.core`` (single device).
