"""CLI alias: `python -m bbbp_tpu_torch.pipelines.train_flow` → bbbp_tpu_torch.train.flow_pipeline."""

from bbbp_tpu_torch.train.flow_pipeline import main

if __name__ == "__main__":
    main()
