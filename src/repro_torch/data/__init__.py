from .pipeline import SyntheticLM, batch_specs
