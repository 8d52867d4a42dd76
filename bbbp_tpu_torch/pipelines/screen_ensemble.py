"""CLI alias: `python -m bbbp_tpu_torch.pipelines.screen_ensemble` → bbbp_tpu_torch.train.weighted_ensemble."""

from bbbp_tpu_torch.train.weighted_ensemble import main

if __name__ == "__main__":
    main()
