"""CLI entry: ``python -m conditional_score_diffusion_tpu_torch.profiling <trace>``."""

from .trace import main

if __name__ == "__main__":
    main()
