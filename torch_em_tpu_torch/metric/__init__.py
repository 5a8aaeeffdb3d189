"""Validation metrics: instance-segmentation decode metrics, clDice, eval measures (host-side numpy)."""

from .cldice import clDice, cl_score
from .eval import (
    contingency_table, matching, rand_index, symmetric_best_dice_score, variation_of_information,
)
from .instance_segmentation_metric import (
    AdaptedRandError, BaseInstanceSegmentationMetric, EmbeddingMWS, EmbeddingMWSIOUMetric,
    EmbeddingMWSRandMetric, EmbeddingMWSSBDMetric, EmbeddingMWSVOIMetric, HDBScan,
    HDBScanIOUMetric, HDBScanRandMetric, HDBScanSBDMetric, HDBScanVOIMetric, IOUError,
    Multicut, MulticutRandMetric, MulticutVOIMetric, MWS, MWSIOUMetric, MWSRandMetric,
    MWSSBDMetric, MWSVOIMetric, SymmetricBestDice, VariationOfInformation, embeddings_to_affinities,
)
