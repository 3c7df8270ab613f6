"""The pipeline's tunables (the port's own copy of the reference's values,
``zuds_tpu/constants.py``; ``tests/test_torch_deblend.py`` holds every
name here equal to the reference's)."""
import math

# --- noise / background ------------------------------------------------------
BIG_RMS = math.sqrt(50000.0)        # sentinel RMS for unusable pixels
BKG_BOX_SIZE = 128                  # background mesh cell size (px)
BKG_VAL = 150.0                     # counts added back after bkg subtraction
SATUR_FRAC = 0.9                    # pixels >= SATUR_FRAC * SATURATE are bad

# --- detection ---------------------------------------------------------------
DETECT_NSIGMA = 1.5                 # detection threshold in filtered sigma
DETECT_NPIX = 5                     # min connected pixels above threshold
DEBLEND_NTHRESH = 32                # multi-threshold deblending levels
DEBLEND_MINCONT = 0.005             # min deblending contrast
CLEAN_PARAM = 1.0                   # CLEAN pass efficiency (sextractor.conf)
MAX_DETECTIONS = 16384              # fixed-capacity detection buffer per frame

# --- photometry --------------------------------------------------------------
APERTURE_RADIUS_PX = 3.0            # forced/aperture photometry radius (px)
APER_KEY = 'APCOR4'                 # header keyword with aperture correction

# --- masking -----------------------------------------------------------------
BAD_BITS = (0, 2, 3, 4, 5, 7, 8, 9, 10, 16, 17)
BAD_SUM = sum(1 << b for b in BAD_BITS)
MASK_BIT_NODATA_ALIGN = 16          # no data after the reference warp
MASK_BIT_NODATA_SUB = 17            # the PSF-match kernel produced no data

MASK_BITS = {f'BIT{i:02d}': i for i in range(17)}
MASK_COMMENTS = {
    'BIT00': 'AIRCRAFT/SATELLITE TRACK',
    'BIT01': 'CONTAINS SEXTRACTOR DETECTION',
    'BIT02': 'LOW RESPONSIVITY',
    'BIT03': 'HIGH RESPONSIVITY',
    'BIT04': 'NOISY',
    'BIT05': 'GHOST FROM BRIGHT SOURCE',
    'BIT06': 'RESERVED FOR FUTURE USE',
    'BIT07': 'PIXEL SPIKE (POSSIBLE RAD HIT)',
    'BIT08': 'SATURATED',
    'BIT09': 'DEAD (UNRESPONSIVE)',
    'BIT10': 'NAN (not a number)',
    'BIT11': 'CONTAINS PSF-EXTRACTED SOURCE POSITION',
    'BIT12': 'HALO FROM BRIGHT SOURCE',
    'BIT13': 'RESERVED FOR FUTURE USE',
    'BIT14': 'RESERVED FOR FUTURE USE',
    'BIT15': 'RESERVED FOR FUTURE USE',
    'BIT16': 'NON-DATA SECTION FROM ALIGNMENT',
}

REFERENCE_VERSION = 'zuds5'

# --- subtraction -------------------------------------------------------------
SUB_NODATA_SENTINEL = 1e-30         # fill value for no-data subtraction pixels
HOTPANTS_SATLEV = 5e3               # saturation level used during kernel fit
KERNEL_RADIUS_SEEING = 2.5          # PSF-match kernel radius = 2.5 * seeing
RSS_SEEING = 6.0                    # stamp half-width = 6 * seeing
NREG_SIDE = 3                       # 3x3 independently-fit kernel regions
KERNEL_SPATIAL_ORDER = 4            # spatial order of kernel variation (-ko 4)
BKG_SPATIAL_ORDER = 0               # spatial order of differential bkg (-bgo 0)
# Gaussian basis (per-gaussian poly degree, per-gaussian sigma factor)
KERNEL_GAUSS_DEGREES = (6, 4, 2)
KERNEL_GAUSS_SIGMAS = (0.7, 1.5, 3.0)

# --- coaddition --------------------------------------------------------------
GROUP_PROPERTIES = ['field', 'ccdid', 'qid', 'fid']
COADD_ZP = 25.0                     # common zeropoint for FLXSCALE normalize
CLIP_NSIGMA = 4.0                   # clipped-mean combine threshold

# --- time / matching ---------------------------------------------------------
MJD_TO_JD = 2400000.5
MATCH_RADIUS_DEG = 0.0002777 * 2.0  # 2 arcsec association radius
RB_ASSOC_MIN = 0.2                  # rb above which leftovers are clustered

# --- execution ---------------------------------------------------------------
NTHREADS_PER_NODE = 64              # mpi.get_nthreads without slurm

# --- ML real/bogus ------------------------------------------------------------
CUTOUT_SIZE = 63                    # braai triplet stamp size (px)
RB_CUT = {1: 0.3, 2: 0.3, 3: 0.6}   # per-filter real/bogus thresholds
BRAAI_MODEL = 'braai_d6_m9'

# --- filters -----------------------------------------------------------------
FID_MAP = {1: 'zg', 2: 'zr', 3: 'zi'}

# --- the rest of the reference's table (its flat namespace exports them) ----
CCL_MAX_ITERS = 64                  # label-propagation sweeps for labeling
N_PREV_SINGLE = 1
N_PREV_MULTI = 1
QUADRANT_NAXIS1 = 3072              # ZTF quadrant width (px)
QUADRANT_NAXIS2 = 3080              # ZTF quadrant height (px)
CMAP_RANDOM_SEED = 8675309
MASK_BORDER = 10  # px synthetic border mask when no weight map exists
ACTIVE_FIELDS = [631, 762, 763, 722, 676, 724, 677,
                 761, 678, 720, 721, 679, 863, 846, 823, 862,
                 845, 822, 793, 844, 759, 821, 719, 792, 758, 791]
STAMP_GRID_PX = 100                 # one kernel stamp per 100x100 px cell
CLIP_GROW = 0.0
