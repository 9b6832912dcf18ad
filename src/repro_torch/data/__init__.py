from repro_torch.data.pipeline import MarkovLM, Prefetcher, SyntheticDataset

__all__ = ["MarkovLM", "Prefetcher", "SyntheticDataset"]
