from repro_torch.data.synth import DATASETS, SynthSpec, load_dataset
