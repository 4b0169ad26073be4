from calitas_tpu_torch.io.fasta import IndexedFasta, SequenceDictionary, ReferenceSetBuilder

__all__ = ["IndexedFasta", "SequenceDictionary", "ReferenceSetBuilder"]
