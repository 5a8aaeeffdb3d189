"""Histopathology datasets."""

from .monuseg import get_monuseg_data, get_monuseg_dataset, get_monuseg_loader, get_monuseg_paths
from .pannuke import get_pannuke_data, get_pannuke_dataset, get_pannuke_loader, get_pannuke_paths
from .tnbc import get_tnbc_data, get_tnbc_dataset, get_tnbc_loader, get_tnbc_paths
from .srsanet import get_srsanet_data, get_srsanet_dataset, get_srsanet_loader, get_srsanet_paths
from .lizard import get_lizard_data, get_lizard_dataset, get_lizard_loader, get_lizard_paths
from .nuinsseg import get_nuinsseg_data, get_nuinsseg_dataset, get_nuinsseg_loader, get_nuinsseg_paths
from .lynsec import get_lynsec_data, get_lynsec_dataset, get_lynsec_loader, get_lynsec_paths
from .cytodark0 import get_cytodark0_data, get_cytodark0_dataset, get_cytodark0_loader, get_cytodark0_paths
from .glas import get_glas_data, get_glas_dataset, get_glas_loader, get_glas_paths
from .cryonuseg import get_cryonuseg_data, get_cryonuseg_dataset, get_cryonuseg_loader, get_cryonuseg_paths
from .janowczyk import get_janowczyk_data, get_janowczyk_dataset, get_janowczyk_loader, get_janowczyk_paths
from .monusac import get_monusac_data, get_monusac_dataset, get_monusac_loader, get_monusac_paths
from .nuclick import get_nuclick_data, get_nuclick_dataset, get_nuclick_loader, get_nuclick_paths
from .cpm import get_cpm_data, get_cpm_dataset, get_cpm_loader, get_cpm_paths
from .conic import get_conic_data, get_conic_dataset, get_conic_loader, get_conic_paths
from .glysac import get_glysac_data, get_glysac_dataset, get_glysac_loader, get_glysac_paths
from .bcss import get_bcss_data, get_bcss_dataset, get_bcss_loader, get_bcsss_paths
from .consep import get_consep_data, get_consep_dataset, get_consep_loader, get_consep_paths
from .panoptils import (
    get_panoptils_data, get_panoptils_dataset, get_panoptils_loader, get_panoptils_paths,
)
from .segpath import (
    get_segpath_data, get_segpath_dataset, get_segpath_loader, get_segpath_paths,
)
from .hest import get_hest_data, get_hest_dataset, get_hest_loader, get_hest_paths
from .orion_crc import get_orion_crc_data, get_orion_crc_dataset, get_orion_crc_loader, get_orion_crc_paths
from .pcns import get_pcns_data, get_pcns_dataset, get_pcns_loader, get_pcns_paths
from .puma import get_puma_data, get_puma_dataset, get_puma_loader, get_puma_paths
