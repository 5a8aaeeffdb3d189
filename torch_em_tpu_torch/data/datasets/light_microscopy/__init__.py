"""Light microscopy datasets."""

from .covid_if import get_covid_if_data, get_covid_if_dataset, get_covid_if_loader, get_covid_if_paths
from .dsb import get_dsb_data, get_dsb_dataset, get_dsb_loader, get_dsb_paths
from .livecell import get_livecell_data, get_livecell_dataset, get_livecell_loader, get_livecell_paths
from .plantseg import get_plantseg_data, get_plantseg_dataset, get_plantseg_loader, get_plantseg_paths
from .ctc import (
    get_ctc_segmentation_data, get_ctc_segmentation_dataset, get_ctc_segmentation_loader,
    get_ctc_segmentation_paths,
)
from .deepbacs import get_deepbacs_data, get_deepbacs_dataset, get_deepbacs_loader, get_deepbacs_paths
from .gonuclear import get_gonuclear_data, get_gonuclear_dataset, get_gonuclear_loader, get_gonuclear_paths
from .mouse_embryo import (
    get_mouse_embryo_data, get_mouse_embryo_dataset, get_mouse_embryo_loader, get_mouse_embryo_paths,
)
from .orgasegment import (
    get_orgasegment_data, get_orgasegment_dataset, get_orgasegment_loader, get_orgasegment_paths,
)
from .omnipose import get_omnipose_data, get_omnipose_dataset, get_omnipose_loader, get_omnipose_paths
from .arvidsson import get_arvidsson_data, get_arvidsson_dataset, get_arvidsson_loader, get_arvidsson_paths
from .vgg_hela import get_vgg_hela_data, get_vgg_hela_dataset, get_vgg_hela_loader, get_vgg_hela_paths
from .ifnuclei import get_ifnuclei_data, get_ifnuclei_dataset, get_ifnuclei_loader, get_ifnuclei_paths
from .embedseg_data import get_embedseg_data, get_embedseg_dataset, get_embedseg_loader, get_embedseg_paths
from .neurips_cell_seg import (
    get_neurips_cellseg_data, get_neurips_cellseg_paths,
    get_neurips_cellseg_supervised_dataset, get_neurips_cellseg_supervised_loader,
    get_neurips_cellseg_unsupervised_dataset, get_neurips_cellseg_unsupervised_loader,
)
from .cellseg_3d import (
    get_cellseg_3d_data, get_cellseg_3d_dataset, get_cellseg_3d_loader, get_cellseg_3d_paths,
)
from .toiam import get_toiam_data, get_toiam_dataset, get_toiam_loader, get_toiam_paths
from .dic_hepg2 import get_dic_hepg2_data, get_dic_hepg2_dataset, get_dic_hepg2_loader, get_dic_hepg2_paths
from .organoidnet import (
    get_organoidnet_data, get_organoidnet_dataset, get_organoidnet_loader, get_organoidnet_paths,
)
from .yeastsam import get_yeastsam_data, get_yeastsam_dataset, get_yeastsam_loader, get_yeastsam_paths
from .brain_organoids import (
    get_brain_organoids_data, get_brain_organoids_dataset, get_brain_organoids_loader,
    get_brain_organoids_paths,
)
from .bac_mother import get_bac_mother_data, get_bac_mother_dataset, get_bac_mother_loader, get_bac_mother_paths
from .vibrio_cholerae import (
    get_vibrio_cholerae_data, get_vibrio_cholerae_dataset, get_vibrio_cholerae_loader,
    get_vibrio_cholerae_paths,
)
from .celegans_atlas import (
    get_celegans_atlas_data, get_celegans_atlas_dataset, get_celegans_atlas_loader,
    get_celegans_atlas_paths,
)
from .microbeseg import (
    get_microbeseg_data, get_microbeseg_dataset, get_microbeseg_loader, get_microbeseg_paths,
)
from .usiigaci import get_usiigaci_data, get_usiigaci_dataset, get_usiigaci_loader, get_usiigaci_paths
from .brifiseg import get_brifiseg_data, get_brifiseg_dataset, get_brifiseg_loader, get_brifiseg_paths
from .nisnet3d import get_nisnet3d_data, get_nisnet3d_dataset, get_nisnet3d_loader, get_nisnet3d_paths
from .deepseas import get_deepseas_data, get_deepseas_dataset, get_deepseas_loader, get_deepseas_paths
from .tissuenet import get_tissuenet_data, get_tissuenet_dataset, get_tissuenet_loader, get_tissuenet_paths
from .cellpose import get_cellpose_data, get_cellpose_dataset, get_cellpose_loader, get_cellpose_paths
from .dynamicnuclearnet import (
    get_dynamicnuclearnet_data, get_dynamicnuclearnet_dataset, get_dynamicnuclearnet_loader,
    get_dynamicnuclearnet_paths,
)
from .oocyteseg import get_oocyteseg_data, get_oocyteseg_dataset, get_oocyteseg_loader, get_oocyteseg_paths
from .glioma_c6 import get_glioma_c6_data, get_glioma_c6_dataset, get_glioma_c6_loader, get_glioma_c6_paths
from .vicar import get_vicar_data, get_vicar_dataset, get_vicar_loader, get_vicar_paths
from .yeastcellseg import (
    get_yeastcellseg_data, get_yeastcellseg_dataset, get_yeastcellseg_loader, get_yeastcellseg_paths,
)
from .hpa import (
    get_hpa_segmentation_data, get_hpa_segmentation_dataset, get_hpa_segmentation_loader,
    get_hpa_segmentation_paths,
)
from .bbbc030 import get_bbbc030_data, get_bbbc030_dataset, get_bbbc030_loader, get_bbbc030_paths
from .bitdepth_nucseg import (
    get_bitdepth_nucseg_data, get_bitdepth_nucseg_dataset, get_bitdepth_nucseg_loader,
    get_bitdepth_nucseg_paths,
)
from .blastospim import (
    get_blastospim_data, get_blastospim_dataset, get_blastospim_loader, get_blastospim_paths,
)
from .mndino import get_mndino_data, get_mndino_dataset, get_mndino_loader, get_mndino_paths
from .bccd import get_bccd_data, get_bccd_dataset, get_bccd_loader, get_bccd_paths
from .lpc_nucseg import (
    get_lpc_nucseg_data, get_lpc_nucseg_dataset, get_lpc_nucseg_loader, get_lpc_nucseg_paths,
)
from .neurosphere import (
    get_neurosphere_data, get_neurosphere_dataset, get_neurosphere_loader, get_neurosphere_paths,
)
from .cvz_fluo import get_cvz_fluo_data, get_cvz_fluo_dataset, get_cvz_fluo_loader, get_cvz_fluo_paths
from .spheroids_hepg2 import (
    get_spheroids_hepg2_data, get_spheroids_hepg2_dataset, get_spheroids_hepg2_loader,
    get_spheroids_hepg2_paths,
)
from .u20s import get_u20s_data, get_u20s_dataset, get_u20s_loader, get_u20s_paths
from .scaffold_a549 import (
    get_scaffold_a549_data, get_scaffold_a549_dataset, get_scaffold_a549_loader,
    get_scaffold_a549_paths,
)
from .parhyale_regen import (
    get_parhyale_regen_data, get_parhyale_regen_dataset, get_parhyale_regen_loader,
    get_parhyale_regen_paths,
)
from .xpress import get_xpress_data, get_xpress_dataset, get_xpress_loader, get_xpress_paths
from .cshaper import get_cshaper_data, get_cshaper_dataset, get_cshaper_loader, get_cshaper_paths
from .enseg import get_enseg_data, get_enseg_dataset, get_enseg_loader, get_enseg_paths
from .balf import get_balf_data, get_balf_dataset, get_balf_loader, get_balf_paths
from .evican import get_evican_data, get_evican_dataset, get_evican_loader, get_evican_paths
from .yeaz import get_yeaz_data, get_yeaz_dataset, get_yeaz_loader, get_yeaz_paths
from .segpc import get_segpc_data, get_segpc_dataset, get_segpc_loader, get_segpc_paths
from .cartocell import (
    get_cartocell_data, get_cartocell_dataset, get_cartocell_loader, get_cartocell_paths,
)
from .orgaextractor import (
    get_orgaextractor_data, get_orgaextractor_dataset, get_orgaextractor_loader,
    get_orgaextractor_paths,
)
from .aisegcell import (
    get_aisegcell_data, get_aisegcell_dataset, get_aisegcell_loader, get_aisegcell_paths,
)
from .bbbc034 import (
    get_bbbc034_data, get_bbbc034_dataset, get_bbbc034_loader, get_bbbc034_paths,
)
from .nis3d import get_nis3d_data, get_nis3d_dataset, get_nis3d_loader, get_nis3d_paths
from .wing_disc import (
    get_wing_disc_data, get_wing_disc_dataset, get_wing_disc_loader, get_wing_disc_paths,
)
from .lsm_mouse_embryo import (
    get_lsm_mouse_embryo_data, get_lsm_mouse_embryo_dataset, get_lsm_mouse_embryo_loader,
    get_lsm_mouse_embryo_paths,
)
from .pnas_arabidopsis import (
    get_pnas_arabidopsis_data, get_pnas_arabidopsis_dataset, get_pnas_arabidopsis_loader,
    get_pnas_arabidopsis_paths,
)
from .phmamm import get_phmamm_data, get_phmamm_dataset, get_phmamm_loader, get_phmamm_paths
from .synthmt import (
    get_synthmt_data, get_synthmt_dataset, get_synthmt_loader, get_synthmt_paths,
)
from .slimia import get_slimia_data, get_slimia_dataset, get_slimia_loader, get_slimia_paths
from .morphoseg import (
    get_morphoseg_data, get_morphoseg_dataset, get_morphoseg_loader, get_morphoseg_paths,
)
from .organoid import (
    get_organoid_data, get_organoid_dataset, get_organoid_loader, get_organoid_paths,
)
from .yeastms import (
    get_yeastms_data, get_yeastms_dataset, get_yeastms_loader, get_yeastms_paths,
)
from .nuc_morph import (
    get_nuc_morph_data, get_nuc_morph_dataset, get_nuc_morph_loader, get_nuc_morph_paths,
)
from .cellbindb import (
    get_cellbindb_data, get_cellbindb_dataset, get_cellbindb_loader, get_cellbindb_paths,
)
from .cisd import get_cisd_data, get_cisd_dataset, get_cisd_loader, get_cisd_paths
from .bmgd import get_bmgd_data, get_bmgd_dataset, get_bmgd_loader, get_bmgd_paths
from .e11bio import get_e11bio_data, get_e11bio_dataset, get_e11bio_loader, get_e11bio_paths
from .idr0095 import get_idr0095_data, get_idr0095_dataset, get_idr0095_loader, get_idr0095_paths
from .liconn import get_liconn_data, get_liconn_dataset, get_liconn_loader, get_liconn_paths
from .medussa import get_medussa_data, get_medussa_dataset, get_medussa_loader, get_medussa_paths
from .morphonet import get_morphonet_data, get_morphonet_dataset, get_morphonet_loader, get_morphonet_paths
from .mucic import get_mucic_data, get_mucic_dataset, get_mucic_loader, get_mucic_paths
from .orgline import get_orgline_data, get_orgline_dataset, get_orgline_loader, get_orgline_paths
