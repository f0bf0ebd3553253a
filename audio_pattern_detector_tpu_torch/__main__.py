"""``python -m audio_pattern_detector_tpu_torch`` dispatches to the CLI."""

from audio_pattern_detector_tpu_torch.cli import main

if __name__ == "__main__":
    main()
