"""CLI alias: `python -m bbbp_tpu_torch.pipelines.train_baseline` → bbbp_tpu_torch.train.baseline."""

from bbbp_tpu_torch.train.baseline import main

if __name__ == "__main__":
    main()
