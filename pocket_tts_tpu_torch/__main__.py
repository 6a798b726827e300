from pocket_tts_tpu_torch.main import main

if __name__ == "__main__":
    raise SystemExit(main())
