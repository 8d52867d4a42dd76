"""CLI alias: `python -m bbbp_tpu_torch.pipelines.train_bert` → bbbp_tpu_torch.train.bert_pipeline."""

from bbbp_tpu_torch.train.bert_pipeline import main

if __name__ == "__main__":
    main()
