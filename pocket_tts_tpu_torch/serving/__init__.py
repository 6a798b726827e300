from pocket_tts_tpu_torch.serving.engine import EngineOverloaded, RequestHandle, TTSEngine

__all__ = ["TTSEngine", "RequestHandle", "EngineOverloaded"]
