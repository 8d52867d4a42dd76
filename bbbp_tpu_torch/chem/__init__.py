"""Chemistry core of the port: copies of the pure-Python modules of
``bbbp_tpu/chem`` (SMILES parsing, molecular graphs, fingerprints,
descriptors, standardization); only their imports differ. The threaded C++
featurizer (``native/bindings.py``) produces the same bits for the
``morgan``, ``rdkit`` and ``maccs`` kinds."""
