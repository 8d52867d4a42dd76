"""CLI alias: `python -m bbbp_tpu_torch.pipelines.train_classify` → bbbp_tpu_torch.train.classification."""

from bbbp_tpu_torch.train.classification import main

if __name__ == "__main__":
    main()
