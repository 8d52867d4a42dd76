"""CLI alias: `python -m bbbp_tpu_torch.pipelines.train_regress` → bbbp_tpu_torch.train.regression."""

from bbbp_tpu_torch.train.regression import main

if __name__ == "__main__":
    main()
