"""Field and curve constants.

Values mirror the reference's scheme constants (reference:
porla/Utils/utils.h:26-44) plus the standard secp256k1 / BN254 curve
parameters (public domain parameters; base-field primes are needed here for
the point arithmetic the reference delegates to libsecp256k1/gnark).
"""

from __future__ import annotations

# --- FFT / erasure-code field (both schemes) -------------------------------
# p = 207 * 2^248 + 1, an FFT-friendly prime (utils.h:31)
FFT_PRIME = 207 * (1 << 248) + 1
assert FFT_PRIME == int(
    "93628759656736142393278101159368737990730026663232799828780155818898507169793")
# The reference's generator constant (utils.h:29, "A random value").
# CAUTION — latent reference bug: this value is NOT a primitive root of
# Z_p* (its order divides (p-1)/6: g^((p-1)/2) = g^((p-1)/3) = 1), so
# w = g^((p-1)/2n) has order n, not 2n. The codeword's Y half therefore
# never reaches the odd 2n-th-root evaluation points and the erasure code
# is strictly weaker than the ICC construction in the paper/MATLAB model
# (icc/find_generator.m uses a true generator). We keep this constant for
# reference parity; hardened deployments use FFT_TRUE_GENERATOR below.
FFT_GENERATOR = int(
    "37724658858582113439798596500054279666200959181261379108294206582568298678")

# Smallest true primitive root of Z_p* (order checked against all prime
# factors of p-1 = 2^248 * 3^2 * 23); gives genuine 2n-th roots of unity
# and a Reed-Solomon (MDS) codeword.
FFT_TRUE_GENERATOR = 5
assert all(pow(FFT_TRUE_GENERATOR, (FFT_PRIME - 1) // q, FFT_PRIME) != 1
           for q in (2, 3, 23))

# --- secp256k1 (IPA scheme) ------------------------------------------------
SECP_P = 2**256 - 2**32 - 977                    # base field
SECP_N = int(                                    # group order (utils.h:27)
    "115792089237316195423570985008687907852837564279074904382605163141518161494337")
SECP_GX = int("79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798", 16)
SECP_GY = int("483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8", 16)
SECP_B = 7

# --- BN254 (KZG scheme) ----------------------------------------------------
BN254_P = int(
    "21888242871839275222246405745257275088696311157297823662689037894645226208583")
BN254_R = int(                                   # group order (utils.h:36)
    "21888242871839275222246405745257275088548364400416034343698204186575808495617")
BN254_B = 3
BN254_G1X = 1
BN254_G1Y = 2
# BN254 curve seed parameter (for the pairing Miller loop)
BN254_X = 4965661367192848881

# --- mixed-modulus data plane ---------------------------------------------
# LCM = p * q: data is kept reduced mod LCM during encoding (utils.h:33,42)
LCM_IPA = FFT_PRIME * SECP_N
LCM_KZG = FFT_PRIME * BN254_R
assert LCM_IPA == int(
    "108414696933520218734836842758930083921010314720502015005158615780106838862712"
    "38884283113399568804205471204971859923723932950084770981108620251449466962241")
assert LCM_KZG == int(
    "20493690311557075739372728100252440647103331181404088976909546514246649746202"
    "15782673575413484558574566298823256897068805013612518402283464943595715297281")


def group_order(scheme: str) -> int:
    return SECP_N if scheme == "ipa" else BN254_R


def lcm_modulus(scheme: str) -> int:
    return LCM_IPA if scheme == "ipa" else LCM_KZG
