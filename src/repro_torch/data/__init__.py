from .pipeline import DataConfig, DataIterator, make_pipeline
from .protein import ProteinCorpus, protein_batch_stream

__all__ = ["DataConfig", "DataIterator", "make_pipeline", "ProteinCorpus",
           "protein_batch_stream"]
