from pocket_tts_tpu_torch.conditioners.text import LUTConditioner, TokenizedText

__all__ = ["LUTConditioner", "TokenizedText"]
