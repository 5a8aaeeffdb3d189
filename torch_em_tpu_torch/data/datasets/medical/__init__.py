"""Medical imaging datasets."""

from .busi import get_busi_data, get_busi_dataset, get_busi_loader, get_busi_paths
from .dca1 import get_dca1_data, get_dca1_dataset, get_dca1_loader, get_dca1_paths
from .montgomery import (
    get_montgomery_data, get_montgomery_dataset, get_montgomery_loader, get_montgomery_paths,
)
from .isic import get_isic_data, get_isic_dataset, get_isic_loader, get_isic_paths
from .drive import get_drive_data, get_drive_dataset, get_drive_loader, get_drive_paths
from .jsrt import get_jsrt_data, get_jsrt_dataset, get_jsrt_loader, get_jsrt_paths
from .jnuifm import get_jnuifm_data, get_jnuifm_dataset, get_jnuifm_loader, get_jnuifm_paths
from .psfhs import get_psfhs_data, get_psfhs_dataset, get_psfhs_loader, get_psfhs_paths
from .micro_usp import get_micro_usp_data, get_micro_usp_dataset, get_micro_usp_loader, get_micro_usp_paths
from .acouslic_ai import (
    get_acouslic_ai_data, get_acouslic_ai_dataset, get_acouslic_ai_loader, get_acouslic_ai_paths,
)
from .spider import get_spider_data, get_spider_dataset, get_spider_loader, get_spider_paths
from .isles import get_isles_data, get_isles_dataset, get_isles_loader, get_isles_paths
from .covid19_seg import (
    get_covid19_seg_data, get_covid19_seg_dataset, get_covid19_seg_loader, get_covid19_seg_paths,
)
from .oasis import get_oasis_data, get_oasis_dataset, get_oasis_loader, get_oasis_paths
from .amd_sd import get_amd_sd_data, get_amd_sd_dataset, get_amd_sd_loader, get_amd_sd_paths
from .papila import get_papila_data, get_papila_dataset, get_papila_loader, get_papila_paths
from .han_seg import get_han_seg_data, get_han_seg_dataset, get_han_seg_loader, get_han_seg_paths
from .camus import get_camus_data, get_camus_dataset, get_camus_loader, get_camus_paths
from .curvas import get_curvas_data, get_curvas_dataset, get_curvas_loader, get_curvas_paths
from .hil_toothseg import (
    get_hil_toothseg_data, get_hil_toothseg_dataset, get_hil_toothseg_loader, get_hil_toothseg_paths,
)
from .pengwin import get_pengwin_data, get_pengwin_dataset, get_pengwin_loader, get_pengwin_paths
from .ct_cadaiver import (
    get_ct_cadaiver_data, get_ct_cadaiver_dataset, get_ct_cadaiver_loader, get_ct_cadaiver_paths,
)
from .motum import get_motum_data, get_motum_dataset, get_motum_loader, get_motum_paths
from .mice_tumseg import (
    get_mice_tumseg_data, get_mice_tumseg_dataset, get_mice_tumseg_loader, get_mice_tumseg_paths,
)
from .leg_3d_us import (
    get_leg_3d_us_data, get_leg_3d_us_dataset, get_leg_3d_us_loader, get_leg_3d_us_paths,
)
from .sega import get_sega_data, get_sega_dataset, get_sega_loader, get_sega_paths
from .verse import get_verse_data, get_verse_dataset, get_verse_loader, get_verse_paths
from .kvasir import get_kvasir_data, get_kvasir_dataset, get_kvasir_loader, get_kvasir_paths
from .uwaterloo_skin import (
    get_uwaterloo_skin_data, get_uwaterloo_skin_dataset, get_uwaterloo_skin_loader,
    get_uwaterloo_skin_paths,
)
from .abus import get_abus_data, get_abus_dataset, get_abus_loader, get_abus_paths
from .idrid import get_idrid_data, get_idrid_dataset, get_idrid_loader, get_idrid_paths
from .ravir import get_ravir_data, get_ravir_dataset, get_ravir_loader, get_ravir_paths
from .siim_acr import get_siim_acr_data, get_siim_acr_dataset, get_siim_acr_loader, get_siim_acr_paths
from .fundus_avseg import (
    get_fundus_avseg_data, get_fundus_avseg_dataset, get_fundus_avseg_loader, get_fundus_avseg_paths,
)
from .oimhs import get_oimhs_data, get_oimhs_dataset, get_oimhs_loader, get_oimhs_paths
from .m2caiseg import get_m2caiseg_data, get_m2caiseg_dataset, get_m2caiseg_loader, get_m2caiseg_paths
from .dsad import get_dsad_data, get_dsad_dataset, get_dsad_loader, get_dsad_paths
from .palm import get_palm_data, get_palm_dataset, get_palm_loader, get_palm_paths
from .amos import get_amos_data, get_amos_dataset, get_amos_loader, get_amos_paths
from .lgg_mri import get_lgg_mri_data, get_lgg_mri_dataset, get_lgg_mri_loader, get_lgg_mri_paths
from .autopet import get_autopet_data, get_autopet_dataset, get_autopet_loader, get_autopet_paths
from .cholecseg8k import (
    get_cholecseg8k_data, get_cholecseg8k_dataset, get_cholecseg8k_loader, get_cholecseg8k_paths,
)
from .feta24 import get_feta24_data, get_feta24_dataset, get_feta24_loader, get_feta24_paths
from .segthy import get_segthy_data, get_segthy_dataset, get_segthy_loader, get_segthy_paths
from .piccolo import get_piccolo_data, get_piccolo_dataset, get_piccolo_loader, get_piccolo_paths
from .toothfairy import (
    get_toothfairy_data, get_toothfairy_dataset, get_toothfairy_loader, get_toothfairy_paths,
)
from .duke_liver import (
    get_duke_liver_data, get_duke_liver_dataset, get_duke_liver_loader, get_duke_liver_paths,
)
from .msd import get_msd_data, get_msd_dataset, get_msd_loader
from .acdc import get_acdc_data, get_acdc_dataset, get_acdc_loader, get_acdc_paths
from .mbh_seg import get_mbh_seg_data, get_mbh_seg_dataset, get_mbh_seg_loader, get_mbh_seg_paths
from .covid_qu_ex import (
    get_covid_qu_ex_data, get_covid_qu_ex_dataset, get_covid_qu_ex_loader, get_covid_qu_ex_paths,
)
from .cbis_ddsm import (
    get_cbis_ddsm_data, get_cbis_ddsm_dataset, get_cbis_ddsm_loader, get_cbis_ddsm_paths,
)
from .ircadb import get_ircadb_data, get_ircadb_dataset, get_ircadb_loader, get_ircadb_paths
from .osic_pulmofib import (
    get_osic_pulmofib_data, get_osic_pulmofib_dataset, get_osic_pulmofib_loader,
    get_osic_pulmofib_paths,
)
from .chaos import get_chaos_data, get_chaos_dataset, get_chaos_loader, get_chaos_paths
from .btcv import get_btcv_data, get_btcv_dataset, get_btcv_loader, get_btcv_paths
from .kits import get_kits_data, get_kits_dataset, get_kits_loader, get_kits_paths
from .panorama import (
    get_panorama_data, get_panorama_dataset, get_panorama_loader, get_panorama_paths,
)
from .plethora import get_plethora_data, get_plethora_dataset, get_plethora_loader, get_plethora_paths
from .sa_med2d import get_sa_med2d_data, get_sa_med2d_dataset, get_sa_med2d_loader, get_sa_med2d_paths
