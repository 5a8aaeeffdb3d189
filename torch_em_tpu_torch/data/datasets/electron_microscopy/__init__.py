"""Electron microscopy datasets."""

from .cremi import get_cremi_data, get_cremi_dataset, get_cremi_loader, get_cremi_paths
from .isbi2012 import get_isbi_data, get_isbi_dataset, get_isbi_loader, get_isbi_paths
from .lucchi import get_lucchi_data, get_lucchi_dataset, get_lucchi_loader, get_lucchi_paths
from .mitoem import get_mitoem_data, get_mitoem_dataset, get_mitoem_loader, get_mitoem_paths
from .snemi import get_snemi_data, get_snemi_dataset, get_snemi_loader, get_snemi_paths
from .vnc import get_vnc_data, get_vnc_mito_dataset, get_vnc_mito_loader, get_vnc_mito_paths
from .kasthuri import get_kasthuri_data, get_kasthuri_dataset, get_kasthuri_loader, get_kasthuri_paths
from .platynereis import (
    get_platynereis_data, get_platynereis_dataset, get_platynereis_loader, get_platynereis_paths,
    get_platynereis_cell_dataset, get_platynereis_cell_loader, get_platynereis_nuclei_dataset,
    get_platynereis_nuclei_loader, get_platynereis_cilia_dataset, get_platynereis_cilia_loader,
)
from .sponge_em import get_sponge_em_data, get_sponge_em_dataset, get_sponge_em_loader, get_sponge_em_paths
from .uro_cell import get_uro_cell_data, get_uro_cell_dataset, get_uro_cell_loader, get_uro_cell_paths
from .nuc_mm import get_nuc_mm_data, get_nuc_mm_dataset, get_nuc_mm_loader, get_nuc_mm_paths
from .axonem import get_axonem_data, get_axonem_dataset, get_axonem_loader, get_axonem_paths
from .cem import (
    get_mitolab_data, get_mitolab_dataset, get_mitolab_loader, get_mitolab_paths,
    get_benchmark_data, get_benchmark_dataset, get_benchmark_loader, get_benchmark_paths,
)
from .densecell import get_densecell_data, get_densecell_dataset, get_densecell_loader, get_densecell_paths
from .emps import get_emps_data, get_emps_dataset, get_emps_loader, get_emps_paths
from .fafb_nuclei import (
    get_fafb_nuclei_data, get_fafb_nuclei_dataset, get_fafb_nuclei_loader, get_fafb_nuclei_paths,
)
from .betaseg import get_betaseg_data, get_betaseg_dataset, get_betaseg_loader, get_betaseg_paths
from .aimseg import get_aimseg_data, get_aimseg_dataset, get_aimseg_loader, get_aimseg_paths
from .human_organoids import (
    get_human_organoids_data, get_human_organoids_dataset, get_human_organoids_loader,
    get_human_organoids_paths,
)
from .deepict import (
    get_deepict_actin_data, get_deepict_actin_dataset, get_deepict_actin_loader,
    get_deepict_actin_paths,
)
from .fib25 import get_fib25_data, get_fib25_dataset, get_fib25_loader, get_fib25_paths
from .manc import get_manc_data, get_manc_dataset, get_manc_loader, get_manc_paths
from .hemibrain import (
    get_hemibrain_data, get_hemibrain_dataset, get_hemibrain_loader, get_hemibrain_paths,
)
from .synapseweb_hippocampus import (
    get_synapseweb_hippocampus_data, get_synapseweb_hippocampus_dataset,
    get_synapseweb_hippocampus_loader, get_synapseweb_hippocampus_paths,
)
from .emneuron import get_emneuron_data, get_emneuron_dataset, get_emneuron_loader, get_emneuron_paths
from .probtem import get_probtem_data, get_probtem_dataset, get_probtem_loader, get_probtem_paths
from .waenet import get_waenet_data, get_waenet_dataset, get_waenet_loader, get_waenet_paths
from .mitoemv2 import get_mitoemv2_data, get_mitoemv2_dataset, get_mitoemv2_loader, get_mitoemv2_paths
from .axondeepseg import (
    get_axondeepseg_data, get_axondeepseg_dataset, get_axondeepseg_loader, get_axondeepseg_paths,
)
from .wildenberg import (
    get_wildenberg_data, get_wildenberg_dataset, get_wildenberg_loader, get_wildenberg_paths,
)
from .zebrafinch import (
    get_zebrafinch_data, get_zebrafinch_dataset, get_zebrafinch_loader, get_zebrafinch_paths,
)
from .hydra_vulgaris import (
    get_hydra_data, get_hydra_dataset, get_hydra_loader, get_hydra_paths,
)
from .mousecc import (
    get_mousecc_data, get_mousecc_dataset, get_mousecc_loader, get_mousecc_paths,
)
from .humanneurons import (
    get_humanneurons_data, get_humanneurons_dataset, get_humanneurons_loader,
    get_humanneurons_paths,
)
from .asem import get_asem_data, get_asem_dataset, get_asem_loader, get_asem_paths
from .astih import get_astih_data, get_astih_dataset, get_astih_loader, get_astih_paths
from .cellmap import get_cellmap_data, get_cellmap_dataset, get_cellmap_loader, get_cellmap_paths
from .malecns import get_malecns_data, get_malecns_dataset, get_malecns_loader, get_malecns_paths
from .microns import (
    get_microns_data, get_microns_dataset, get_microns_loader, get_microns_paths,
    get_microns_minnie65_data, get_microns_minnie65_dataset, get_microns_minnie65_loader,
    get_microns_minnie65_paths,
)
from .microns_nuclei import (
    get_microns_nuclei_data, get_microns_nuclei_dataset, get_microns_nuclei_loader, get_microns_nuclei_paths,
)
from .nisb import get_nisb_data, get_nisb_dataset, get_nisb_loader, get_nisb_paths
