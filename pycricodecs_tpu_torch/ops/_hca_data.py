"""Embedded binary constant tables of the CRI HCA bitstream format (decode half).

Format-defined lookup tables (psychoacoustic ATH curve, resolution inversion
table, IMDCT twiddle factors and window) whose exact fp32 bit patterns are
required for bit-exact decode. Stored as base85 blobs, decoded once at import;
the same blobs as pycricodecs_tpu/ops/_hca_data.py (tests hold them equal).
Parity anchors in the reference implementation: hca.cpp:407 (ath),
hca.cpp:1444-1494 (invert table), hca.cpp:1741-1894 (IMDCT twiddles/window).
"""
import base64

import numpy as np


def _f32(blob):
    return np.frombuffer(base64.b85decode(blob), dtype="<u4").view(np.float32).copy()


def _u8(blob):
    return np.frombuffer(base64.b85decode(blob), dtype="u1").copy()


ATH_BASE_CURVE = _u8(
    "cwbggPE1QlNJvLUMny$ML_|bHLqkJDLqkGBLPA19LP9}7K|w)5K|w)5KtMo1KtMo1KtDe}KR-V|KR-V|KR-V{K0ZD^K0Q4>J"
    "v}`=JUl!+JUl!+J3Bi&J3Bi&J3Bi&J3Bi&J3Bi&J3Bi&J3Bi&J3Bi&JUl!+JUl!+Jv}`=Jv}`=K0ZD^K0ZD_KR-V|KR-V|KR"
    "-V|KR-V|KR-V|KtMo1KtMo1KtMo1KtMo1KtMo1KtVx4K|w)5K|w)5K|w)5K|w)5K|w)5K|w)5K|w)6LPA19LPA19LPA19LPA"
    "19LPA19LPJACLqkJDLqkJDLqkJDLqkMFL_|bHL_|bHL_|bHMMXtLMMXtLMMXtLMn*<PMn*<PMn*?RM@L6TM@L6TNJvOXNJvO"
    "XNl8gbNl8gbN=iyfN=iyfOG`^jOG`^kOiWBnOifKqO-)TsPEJlvPESuyPft%!P*6}%QBhG*QBqP;Qc_b>Q&Ut_R8&+|RaI41"
    "R#sM5S65e8SXfwDSy@?HT3T9LTU%RPTwGmUU0q&YUSD5dU|?WjVPRonVq#-sV`OAxWo2e&W@l$-XlQ6@X=-X}Yinz4Y;A3AZ"
    "f<XHaBy&OadL8Vb8~cbb#-=jcXxPrczJnxdV70(e0_a>et&;}fPsO6gM);Gg@uNOhlq%YiHeGgjEs$qj*pL!kdcy-la!Q|m6"
    "n&6n3<WHo12`Sot~edprN9oqok#!rl+T<sj8~0tgWuDuduPPva__cwzjvpxw^W$yuH4^z`?=7!^FkL$H>Xa%FE2n&d<=%($m"
    "z{*4NnC+S}aS-rwNi;^XAy=I7|?>g(<9@9^>R^Yr!i`1$(#{Qdv`"
)

INVERT_TABLE = _u8(
    "4h{|u4h{_s4Gj$q3=9km3=9hk3kwSi3JMAe3JMAd2?+@a2?z)X2nYxV1_lKL1Ox*E0|Ej90s#R50RaI40Ra"
)

IMDCT_SIN = _f32(
    "bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&b"
    "v>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv"
    ">s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>"
    "s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^"
    "uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>"
    "z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG"
    "22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>ZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8"
    "jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J"
    "|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>"
    "*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?N"
    "53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42"
    "nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-"
    "sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7"
    "%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=bL+pP)ZBBnbBolr=C_8*VoyU1U2fB7YM-+2Ep4e_brwM95S*m0|1-@QCQ%G1pJxx("
    "R646ONaM(dVLTEWZL+pP)ZBBnbBolr=C_8*VoyU1U2fB7YM-+2Ep4e_brwM95S*m0|1-@QCQ%G1pJxx(R646ONaM(dVLTEWZ"
    "L+pP)ZBBnbBolr=C_8*VoyU1U2fB7YM-+2Ep4e_brwM95S*m0|1-@QCQ%G1pJxx(R646ONaM(dVLTEWZL+pP)ZBBnbBolr=C"
    "_8*VoyU1U2fB7YM-+2Ep4e_brwM95S*m0|1-@QCQ%G1pJxx(R646ONaM(dVLTEWZ5&M5Xm(zbgtAu|)SPp+buyB4q%&UDr$-"
    "jI*&8&Mr0&{vlm=bwE#fx`8#@=;5-3xR-QWJ7NbM<dOld^3;3`=W2Jill^h!18zT0CPvAx2<7Q!QOTYVuh><&{=HNf=W<A9_"
    "ze_`6F#W!^_W0OCVGXU9K3JC8d*BRV%f5&M5Xm(zbgtAu|)SPp+buyB4q%&UDr$-jI*&8&Mr0&{vlm=bwE#fx`8#@=;5-3xR"
    "-QWJ7NbM<dOld^3;3`=W2Jill^h!18zT0CPvAx2<7Q!QOTYVuh><&{=HNf=W<A9_ze_`6F#W!^_W0OCVGXU9K3JC8d*BRV%f"
    "#QuLj=JbC*DdB%VkHddI7@U7U$7+8+oiBeso$7u+$(w#ZBSU^avEY3_baZ_`bN+lkuzq|$G4*>t{9$`P7R7o$gdTc7PHuTWd"
    "$f2z5b<|E7bJH-mrZs*mu+=FB7}55Kaq1k_>^)#SC4T&W`J-%FlcW-zD9089UN^xSm<j%d#h?ck!5K=s1|5H%)Vwn3tnYEbM"
    "#|B5Q1Vq@&;i)Cxc%<zV=-|$6;JQP{dk4Y93iXCU93jletwt!}?P{#xqhsuVhd^kd011d9F-9f5%Ecv)D*KD&j^z_2Wc8Dc("
    "Xq+R#8h8@xV01E4%Vq<lI*7E(ArY#=s2"
).reshape(7, 64)

IMDCT_COS = _f32(
    ")Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)Qbu|)Qbu|)Qbwe)Qbwe)Qbu|)Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)"
    "Qbu|)Qbwe)Qbu|)Qbu|)Qbwe)Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)Qbu|)Qbu|)Qbwe)Qbwe)Qbu|)Qbwe)Qbu|)Q"
    "bu|)Qbwe)Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)Qbu|)Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)Qbu|)Qbu|)Qb"
    "we)Qbwe)Qbu|)Qbwe)Qbu|)Qbu|)Qbwe!o^3v+Bput!o^2E+BptC!o^2E+BptC!o^3v+Bput!o^2E+BptC!o^3v+Bput!o^3"
    "v+Bput!o^2E+BptC!o^2E+BptC!o^3v+Bput!o^3v+Bput!o^2E+BptC!o^3v+Bput!o^2E+BptC!o^2E+BptC!o^3v+Bput"
    "!o^2E+BptC!o^3v+Bput!o^3v+Bput!o^2E+BptC!o^3v+Bput!o^2E+BptC!o^2E+BptC!o^3v+Bput!o^3v+Bput!o^2E+"
    "BptC!o^2E+BptC!o^3v+Bput!o^2E+BptC!o^3v+Bput!o^3v+Bput!o^2E+BptCHoeHbF`$&b>RR!>nP(!uHoeF_F`$$_>R"
    "RzWnP(zDHoeF_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!uHoeF_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!uHoeHbF`$"
    "&b>RR!>nP(!uHoeF_F`$$_>RRzWnP(zDHoeF_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!uHoeHbF`$&b>RR!>nP(!uHoeF"
    "_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!uHoeF_F`$$_>RRzWnP(zDHoeF_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!u"
    "F#AZogFqI(%+Gkf)O@VIfau!3J)8r-z<(IOO6x1XF#AY7gFqHO%+Gi})O@TyfauyjJ)8qSz<(G&O6w~>F#AY7gFqHO%+Gi})"
    "O@TyfauyjJ)8qSz<(G&O6w~>F#AZogFqI(%+Gkf)O@VIfau!3J)8r-z<(IOO6x1XF#AY7gFqHO%+Gi})O@TyfauyjJ)8qSz<"
    "(G&O6w~>F#AZogFqI(%+Gkf)O@VIfau!3J)8r-z<(IOO6x1XF#AZogFqI(%+Gkf)O@VIfau!3J)8r-z<(IOO6x1XF#AY7gFq"
    "HO%+Gi})O@TyfauyjJ)8qSz<(G&O6w~>unNh%1*w+3bF%uqq7W~>6I@`vla7eK<(i<rDnz)x%6regbu;F^Ctdu$oAn64Drgh"
    "G(SIGkRyHTUyM-{nunNgM1*w)jbF%t9q7W}W6I@_Ela7c!<(i;ADnz(G%6rc~bu;EZCtdtLoAn4kDrgfw(SIF3RyHR;yM-`6"
    "unNgM1*w)jbF%t9q7W}W6I@_Ela7c!<(i;ADnz(G%6rc~bu;EZCtdtLoAn4kDrgfw(SIF3RyHR;yM-`6unNh%1*w+3bF%uqq"
    "7W~>6I@`vla7eK<(i<rDnz)x%6regbu;F^Ctdu$oAn64DrghG(SIGkRyHTUyM-{nkPb<_EW;MPbSrzkfVQu_F1+ErhR+GUwy"
    "Pq(&u%-u0Tooff0}H*z<q+gBASlAhM=0h5|5_7?_;vQN*%twQ@P2$K{nOCPm<uiyUXjo%i#9D<mUjtf=dR!Ynltc&C?LS+4d"
    "E`#sV9^%l03?CDJ6n6_hEz-a9V8$;dLlkPb;aEW;K(bSry3fVQtaF1+DAhR+E;wyPpO&u%+D0Tom}f0}GQz<q)~BASjqhM<~"
    "05|5@n?_;t)N*%sFQ@P1LK{nMsPm<t1yUXi7%i#7t<mUiCf=dQJYnlr`&C?J++4dDb#sV8Z%l02XCDJ566_hDI-a9To$;dK4"
    "h!4rTw#k;fx=H)I2jDNgX%u3;3LuKTj4-3U!#cdZxjogrb~x_60+j>4w+Ilv-gX?m{N5<Om_RkYH=9AeVD3%6mpNL#W_)J8Q"
    "MPiv;pTq6&W44)2bGJy-JOxX7onHFc%GfU#g(JJ#D=N9I&rVQ>{PYBpfS6?9tXj`Db>cli<`{830l&=YY^DJdA{Ag`eWn1w*"
    "cwBd6e$H2OsplEui_nvKRlpu|fjBg!BZzHlYW<tw;*L(CQ4ogoh8mupSb>Ij|JJ2Rs+Q0Kyr+3_={g61*P2`7a^AshuOg3I!"
    "&=1!gF}g1{=jX%sELrC~3>9jGzCyyr8&"
).reshape(7, 64)

IMDCT_WINDOW = _f32(
    "@B}qFxPt*ZIK^-~Xp*}-38(}-0D>?)OekSI7e9+Uk~ye6y?@6%5E1D-&36Vp#E%(0T+=N*Lq<bA!R%Q*sLOFZ9(0906Qq(ow"
    "0NLBBK594o*ceCd-Baa9eUn9?Y8edE7kx$+Aaz{D(4eEu>c-E@_Z;hRb4YaA)`J%bx%q@KVw!tH{W7D(Zg>(I1zn5qGN?Vw{"
    "na=VYQP!?<$)<Z_=VZtE#F#BC@hR2IsmyH%G%hJ<!WOMt{^kC{f)$TtenP|4#2d*K+tisnh^J%60`mI~@u?NW~66C2SKv@(v"
    "h3!m1oUqC6o#rNJdX=Qb)on3*m=1?Mt9o*Xy7{x>_n@-{!efEPo*=GR8Qq;^WbeDY1dZ%R?W#eG!21B_R{?sQtehd5oo2iIS"
    "}+E8M@nWkjF2-#-84(VvWvDa$95vFXvVpVRx=jLy}?^|)d(Y12F=Jj*Gi5+#n6E1eY*C=<tAP;!IG~#%_Orv?fms5JbIrMtJ"
    "NQQgA&I)|L$bx*oChvT|%TRs4j;MXVH}`$NhCP12Dtvyw%(H&K2jzahY!H9HgEoJ^%2$8Cwse2LwvB(kE~9_Hd$oVR_QZd`?"
    "a_a~t=xaVdF6k<knDfIF7kiBi1vTK(D{GAGW>tP+WmjO?f!qikN<za-~WHV{QrNy"
)
