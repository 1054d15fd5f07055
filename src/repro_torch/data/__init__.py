from repro_torch.data.synthetic import make_dataset, DATASETS, SynthDataset
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.data.loader import PackedLoader
