from repro_torch.data.synth import DATASETS, SynthSpec, load_dataset
from repro_torch.data.tokens import TokenPipeline
